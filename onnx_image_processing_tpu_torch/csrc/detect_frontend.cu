// Fused Shi-Tomasi score + NMS keep mask + orientation moments, for Hopper
// (sm_90a).
//
// Replaces: onnx_image_processing_tpu/kernels/detect_frontend.py,
//   detect_frontend -> _detect_kernel (the Pallas TPU kernel). Plain twin:
//   detect_frontend_plain in
//   onnx_image_processing_tpu_torch/kernels/detect_frontend.py, the port of
//   detect_frontend_reference (shi_tomasi_score, nms_maxpool, angle_moments).
//
// Computes, per pixel: the Shi-Tomasi lambda_min of the Sobel structure
// tensor summed over a block_size box, clamped at 0; the NMS keep mask
// `score >= local_max - 1e-7f` over a (2r+1)^2 window; the output
// score * keep; and, with_angle, the Gaussian moments m10, m01. Three border
// rules, each the twin's:
//   1. the Sobel reads the edge-replicated image;
//   2. the box sums read the edge-replicated PRODUCT maps, i.e. ix*ix etc.
//      taken at the clamped position, not products of Sobels of the
//      extended image;
//   3. the NMS window counts cells outside the image as -inf;
// and the moments read the zero-padded image.
//
// Arithmetic: every multiply, add and the square root are rounded on their
// own (__fmul_rn, __fadd_rn, __fsqrt_rn) in the twin's order (vertical
// taps, then horizontal, zero taps skipped), so nvcc contracts nothing into
// an fma. The moment taps come from the caller (the twin's float32 numpy
// values).
//
// What bounds it on this card: one read of the image and three writes, about
// 3.7 MB at 2 x 480 x 640, under 2 us at 3.35 TB/s; the ~600 flops per pixel
// (mostly the two 15-tap moment passes) take a few us more. The plain
// version is ~100 launches; this is one.
// Design: one CTA per 32x32 output tile holds, in shared memory, the clamped
// image with a halo of max(1 + box radius + NMS radius, moment half-width),
// the three product maps on the tile plus box + NMS radius, and the score
// on the tile plus the NMS radius (-inf outside the image). The window max
// is separable (rows, then columns). The product buffer is reused for the
// row maxima and then for the moments' vertical pass. No size limit: any
// H x W runs as more tiles.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Geometry {
  int hi, is;  // image halo and side
  int ph, ps;  // product maps' halo and side
  int ss;      // score side (halo = NMS radius)
  int mw;      // width of the moments' vertical pass
  int nt;      // moment taps
  int scratch; // floats of the buffer shared by products, row maxima, moments
};

__host__ __device__ inline Geometry geometry(int rb, int rn, int half) {
  Geometry g;
  g.ph = rb + rn;
  g.hi = g.ph + 1 > half ? g.ph + 1 : half;
  g.is = kTile + 2 * g.hi;
  g.ps = kTile + 2 * g.ph;
  g.ss = kTile + 2 * rn;
  g.mw = kTile + 2 * half;
  g.nt = 2 * half + 1;
  int s = 3 * g.ps * g.ps;
  if (g.ss * kTile > s) s = g.ss * kTile;
  if (2 * kTile * g.mw > s) s = 2 * kTile * g.mw;
  g.scratch = s;
  return g;
}

__global__ void detect_frontend_kernel(const float* __restrict__ image,
                                       const float* __restrict__ taps,
                                       float* __restrict__ score_out,
                                       float* __restrict__ m10_out,
                                       float* __restrict__ m01_out,
                                       int h, int w, int rb, int rn, int half,
                                       int with_angle) {
  extern __shared__ float smem[];
  const Geometry geo = geometry(rb, rn, half);
  const int IS = geo.is, PS = geo.ps, SS = geo.ss, MW = geo.mw, nt = geo.nt;
  float* img = smem;                      // IS x IS, edge-replicated image
  float* sc = img + IS * IS;              // SS x SS score, -inf outside
  float* g = sc + SS * SS;                // nt Gaussian taps, then nt t*g taps
  float* tg = g + nt;
  float* scratch = tg + nt;
  float* pxx = scratch;                   // PS x PS product maps
  float* pyy = pxx + PS * PS;
  float* pxy = pyy + PS * PS;

  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.z * h * w;
  const float* src = image + base;

  if (with_angle)
    for (int i = threadIdx.x; i < 2 * nt; i += blockDim.x) g[i] = taps[i];
  for (int i = threadIdx.x; i < IS * IS; i += blockDim.x) {
    const int gy = clampi(y0 - geo.hi + i / IS, 0, h - 1);
    const int gx = clampi(x0 - geo.hi + i % IS, 0, w - 1);
    img[i] = src[(size_t)gy * w + gx];
  }
  __syncthreads();

  // Products of the replicate-padded Sobels, each taken at the clamped
  // position (border rules 1 and 2).
  for (int i = threadIdx.x; i < PS * PS; i += blockDim.x) {
    const int cy = clampi(y0 - geo.ph + i / PS, 0, h - 1);
    const int cx = clampi(x0 - geo.ph + i % PS, 0, w - 1);
    const float* p = img + (cy - 1 - y0 + geo.hi) * IS + (cx - 1 - x0 + geo.hi);
    // ix = outer([1,2,1], [-1,0,1]), iy = outer([-1,0,1], [1,2,1])
    const float v0 = add(add(p[0], mul(2.f, p[IS])), p[2 * IS]);
    const float v2 = add(add(p[2], mul(2.f, p[IS + 2])), p[2 * IS + 2]);
    const float ix = add(-v0, v2);
    const float u0 = add(-p[0], p[2 * IS]);
    const float u1 = add(-p[1], p[2 * IS + 1]);
    const float u2 = add(-p[2], p[2 * IS + 2]);
    const float iy = add(add(u0, mul(2.f, u1)), u2);
    pxx[i] = mul(ix, ix);
    pyy[i] = mul(iy, iy);
    pxy[i] = mul(ix, iy);
  }
  __syncthreads();

  // Box sums (vertical, then horizontal) and lambda_min; -inf outside the
  // image for the NMS window (border rule 3).
  const int bw = 2 * rb + 1;
  for (int i = threadIdx.x; i < SS * SS; i += blockDim.x) {
    const int si = i / SS, sj = i % SS;
    float s = -INFINITY;
    if (y0 - rn + si >= 0 && y0 - rn + si < h && x0 - rn + sj >= 0 && x0 - rn + sj < w) {
      float sxx = 0.f, syy = 0.f, sxy = 0.f;
      for (int dx = 0; dx < bw; ++dx) {
        const int o = si * PS + sj + dx;
        float cxx = pxx[o], cyy = pyy[o], cxy = pxy[o];
        for (int dy = 1; dy < bw; ++dy) {
          cxx = add(cxx, pxx[o + dy * PS]);
          cyy = add(cyy, pyy[o + dy * PS]);
          cxy = add(cxy, pxy[o + dy * PS]);
        }
        sxx = dx ? add(sxx, cxx) : cxx;
        syy = dx ? add(syy, cyy) : cyy;
        sxy = dx ? add(sxy, cxy) : cxy;
      }
      const float half_trace = mul(add(sxx, syy), 0.5f);
      const float diff_half = mul(__fsub_rn(sxx, syy), 0.5f);
      const float disc = add(mul(diff_half, diff_half), mul(sxy, sxy));
      const float lam = __fsub_rn(half_trace, __fsqrt_rn(add(disc, 1e-10f)));
      s = lam < 0.f ? 0.f : lam;
    }
    sc[i] = s;
  }
  __syncthreads();

  float* rowmax = scratch;                // SS x kTile
  for (int i = threadIdx.x; i < SS * kTile; i += blockDim.x) {
    const float* row = sc + (i / kTile) * SS + i % kTile;
    float m = row[0];
    for (int d = 1; d <= 2 * rn; ++d) m = fmaxf(m, row[d]);
    rowmax[i] = m;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    float lm = rowmax[r * kTile + c];
    for (int d = 1; d <= 2 * rn; ++d) lm = fmaxf(lm, rowmax[(r + d) * kTile + c]);
    const float s = sc[(r + rn) * SS + c + rn];
    score_out[base + (size_t)gy * w + gx] = mul(s, s >= __fsub_rn(lm, 1e-7f) ? 1.f : 0.f);
  }
  if (!with_angle) return;
  __syncthreads();  // the row maxima are read before the moments reuse scratch

  // Moments of the zero-padded image: vertical pass (g and t*g), then
  // horizontal (t*g for m10, g for m01).
  float* vg = scratch;                    // kTile x MW
  float* vtg = vg + kTile * MW;
  for (int i = threadIdx.x; i < kTile * MW; i += blockDim.x) {
    const int r = i / MW, j = i % MW;
    const int gx = x0 - half + j;
    float ag = 0.f, atg = 0.f;
    bool any_g = false, any_tg = false;
    for (int t = 0; t < nt; ++t) {
      const int gy = y0 + r + t - half;
      const float x = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                          ? img[(gy - y0 + geo.hi) * IS + gx - x0 + geo.hi] : 0.f;
      if (g[t] != 0.f) { const float v = mul(g[t], x); ag = any_g ? add(ag, v) : v; any_g = true; }
      if (tg[t] != 0.f) { const float v = mul(tg[t], x); atg = any_tg ? add(atg, v) : v; any_tg = true; }
    }
    vg[i] = ag;
    vtg[i] = atg;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    float a10 = 0.f, a01 = 0.f;
    bool any10 = false, any01 = false;
    for (int t = 0; t < nt; ++t) {
      if (tg[t] != 0.f) { const float v = mul(tg[t], vg[r * MW + c + t]); a10 = any10 ? add(a10, v) : v; any10 = true; }
      if (g[t] != 0.f) { const float v = mul(g[t], vtg[r * MW + c + t]); a01 = any01 ? add(a01, v) : v; any01 = true; }
    }
    m10_out[base + (size_t)gy * w + gx] = a10;
    m01_out[base + (size_t)gy * w + gx] = a01;
  }
}

}  // namespace

// image (b, h, w) f32 -> score (b, h, w) and, with_angle, m10, m01 (b, h, w).
// rb = block_size / 2, rn = NMS radius, half = patch_size / 2; taps holds the
// 2*half+1 Gaussian taps g, then t*g (read only with_angle). Returns
// cudaGetLastError() after the launch.
extern "C" int oip_detect_frontend(const float* image, const float* taps,
                                   float* score, float* m10, float* m01, int b,
                                   int h, int w, int rb, int rn, int half,
                                   int with_angle, void* stream) {
  const Geometry geo = geometry(rb, rn, half);
  const size_t smem = sizeof(float) * ((size_t)geo.is * geo.is + (size_t)geo.ss * geo.ss +
                                       2 * geo.nt + geo.scratch);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(detect_frontend_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  detect_frontend_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      image, taps, score, m10, m01, h, w, rb, rn, half, with_angle);
  return (int)cudaGetLastError();
}
