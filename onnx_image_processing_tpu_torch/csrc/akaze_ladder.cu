// AKAZE scale ladder: FED diffusion steps, Hessian NMS score and orientation
// moments of every scale, for Hopper (sm_90a).
//
// Replaces: onnx_image_processing_tpu/kernels/akaze_ladder.py, akaze_ladder
//   -> _ladder_kernel (the Pallas TPU kernel). Plain twin:
//   akaze_ladder_plain in onnx_image_processing_tpu_torch/kernels/akaze_ladder.py,
//   the port of ops/akaze.py akaze_ladder_reference.
//
// Computes, per image, for each of num_scales scales: `iters` explicit FED
// steps L += 0.25 * (sobel_x(c*gx) + sobel_y(c*gy)), c = 1/(1 + |g|^2 inv_k2),
// the state carried from one scale to the next; then the Hessian response
// lxx*lyy - lxy*lxy with a zero-padded max-pool equality NMS, the threshold
// mask and a clamp at 0; and the Gaussian moments m10, m01 of L (15-tap
// separable, zero padding). Every 3x3 stencil zero-pads its own input, so
// the fluxes c*gx, c*gy are 0 outside the image before the divergence.
//
// Arithmetic: every multiply and add is rounded on its own (__fmul_rn,
// __fadd_rn), in the twin's order: vertical taps, then horizontal, then the
// scale, zero taps skipped. nvcc would otherwise contract a*b + c into an
// fma and move the last bit. The moment taps come from the caller (the
// twin's float32 numpy values), not from expf on the device.
//
// What bounds it on this card: each FED step needs the whole previous state,
// and a 480x640 f32 image (1.2 MB) does not fit one CTA's shared memory, so
// the TPU kernel's whole-image residency does not carry over. The work is
// ~60 flops per pixel per step over a map that lives in the 50 MB L2, so
// launch latency and the L2 trips bound it, not HBM or arithmetic.
// Design: one launch per FED step (a 32x32 tile plus a 2-pixel halo of L in
// shared memory; fluxes on the tile plus 1, divergence on the tile; two
// ping-pong state buffers), then one launch per scale for its outputs (L
// with a halo of max(nms radius + 1, moment half-width), response on the
// tile plus the NMS radius, the moments as a vertical then a horizontal
// pass in shared memory). 12 launches for 3 scales of 3 steps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

// Zero-padded Sobel/8 pair at the centre of a 3x3 window p[dy * ld + dx]:
// x: outer([1,2,1], [-1,0,1]) / 8; y: outer([-1,0,1], [1,2,1]) / 8.
__device__ __forceinline__ float sobel_x(const float* p, int ld) {
  const float v0 = add(add(p[0], mul(2.f, p[ld])), p[2 * ld]);
  const float v2 = add(add(p[2], mul(2.f, p[ld + 2])), p[2 * ld + 2]);
  return mul(add(-v0, v2), 0.125f);
}

__device__ __forceinline__ float sobel_y(const float* p, int ld) {
  const float u0 = add(-p[0], p[2 * ld]);
  const float u1 = add(-p[1], p[2 * ld + 1]);
  const float u2 = add(-p[2], p[2 * ld + 2]);
  return mul(add(add(u0, mul(2.f, u1)), u2), 0.125f);
}

// One FED step of every image: l_out = l_in + 0.25 * div(c * grad l_in).
__global__ void fed_step_kernel(const float* __restrict__ l_in,
                                float* __restrict__ l_out, int h, int w,
                                float inv_k2) {
  constexpr int LS = kTile + 4;  // L: tile plus a 2-pixel halo, 0 outside
  constexpr int FS = kTile + 2;  // fluxes: tile plus 1, 0 outside the image
  __shared__ float ls[LS * LS];
  __shared__ float fx[FS * FS];
  __shared__ float fy[FS * FS];
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.z * h * w;

  for (int i = threadIdx.x; i < LS * LS; i += blockDim.x) {
    const int gy = y0 - 2 + i / LS, gx = x0 - 2 + i % LS;
    ls[i] = inside(gy, gx, h, w) ? l_in[base + (size_t)gy * w + gx] : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < FS * FS; i += blockDim.x) {
    const int r = i / FS, c = i % FS;  // centred on ls cell (r + 1, c + 1)
    float cgx = 0.f, cgy = 0.f;
    if (inside(y0 - 1 + r, x0 - 1 + c, h, w)) {
      const float* p = ls + r * LS + c;
      const float gx = sobel_x(p, LS), gy = sobel_y(p, LS);
      const float mag2 = add(add(mul(gx, gx), mul(gy, gy)), 1e-8f);
      const float cc = __fdiv_rn(1.f, add(1.f, mul(mag2, inv_k2)));
      cgx = mul(cc, gx);
      cgy = mul(cc, gy);
    }
    fx[i] = cgx;
    fy[i] = cgy;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    const float div = add(sobel_x(fx + r * FS + c, FS), sobel_y(fy + r * FS + c, FS));
    l_out[base + (size_t)gy * w + gx] = add(ls[(r + 2) * LS + c + 2], mul(0.25f, div));
  }
}

// Outputs of one scale from its diffused state l: score, m10, m01 at
// [b, s] of the (B, S, H, W) outputs.
__global__ void scale_out_kernel(const float* __restrict__ l,
                                 const float* __restrict__ taps,
                                 float* __restrict__ score,
                                 float* __restrict__ m10,
                                 float* __restrict__ m01, int h, int w, int s,
                                 int num_scales, float thr, int nr, int half) {
  extern __shared__ float smem[];
  const int hl = max(nr + 1, half);    // halo of L
  const int LS = kTile + 2 * hl;
  const int RS = kTile + 2 * nr;       // response: tile plus the NMS radius
  const int MW = kTile + 2 * half;     // moments' vertical pass width
  const int nt = 2 * half + 1;
  float* ls = smem;                    // LS x LS, 0 outside the image
  float* resp = ls + LS * LS;          // RS x RS, 0 outside the image
  float* rowmax = resp + RS * RS;      // RS x kTile
  float* vg = rowmax + RS * kTile;     // kTile x MW, vertical pass with g
  float* vtg = vg + kTile * MW;        // kTile x MW, vertical pass with t*g
  float* g = vtg + kTile * MW;         // nt taps
  float* tg = g + nt;                  // nt taps

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const float* img = l + (size_t)b * h * w;

  for (int i = threadIdx.x; i < 2 * nt; i += blockDim.x) g[i] = taps[i];
  for (int i = threadIdx.x; i < LS * LS; i += blockDim.x) {
    const int gy = y0 - hl + i / LS, gx = x0 - hl + i % LS;
    ls[i] = inside(gy, gx, h, w) ? img[(size_t)gy * w + gx] : 0.f;
  }
  __syncthreads();

  // Hessian response: lxx = outer([1,2,1], [1,-2,1]) / 16,
  // lyy = outer([1,-2,1], [1,2,1]) / 16, lxy = outer([1,0,-1], [1,0,-1]) / 4.
  for (int i = threadIdx.x; i < RS * RS; i += blockDim.x) {
    const int ri = i / RS, ci = i % RS;
    float v = 0.f;
    if (inside(y0 - nr + ri, x0 - nr + ci, h, w)) {
      const float* p = ls + (ri - nr + hl - 1) * LS + (ci - nr + hl - 1);
      float a[3], c[3], d[3];
      for (int k = 0; k < 3; ++k) {
        a[k] = add(add(p[k], mul(2.f, p[LS + k])), p[2 * LS + k]);
        c[k] = add(add(p[k], mul(-2.f, p[LS + k])), p[2 * LS + k]);
        d[k] = add(p[k], -p[2 * LS + k]);
      }
      const float lxx = mul(add(add(a[0], mul(-2.f, a[1])), a[2]), 0.0625f);
      const float lyy = mul(add(add(c[0], mul(2.f, c[1])), c[2]), 0.0625f);
      const float lxy = mul(add(d[0], -d[2]), 0.25f);
      v = __fsub_rn(mul(lxx, lyy), mul(lxy, lxy));
    }
    resp[i] = v;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < RS * kTile; i += blockDim.x) {
    const float* row = resp + (i / kTile) * RS + i % kTile;
    float m = row[0];
    for (int d = 1; d <= 2 * nr; ++d) m = fmaxf(m, row[d]);
    rowmax[i] = m;
  }
  // Vertical moment passes over the zero-padded L (reads only ls).
  for (int i = threadIdx.x; i < kTile * MW; i += blockDim.x) {
    const int r = i / MW, j = i % MW;
    const float* col = ls + (r - half + hl) * LS + (j - half + hl);
    float ag = 0.f, atg = 0.f;
    bool any_g = false, any_tg = false;
    for (int t = 0; t < nt; ++t) {
      const float x = col[t * LS];
      if (g[t] != 0.f) { const float v = mul(g[t], x); ag = any_g ? add(ag, v) : v; any_g = true; }
      if (tg[t] != 0.f) { const float v = mul(tg[t], x); atg = any_tg ? add(atg, v) : v; any_tg = true; }
    }
    vg[i] = ag;
    vtg[i] = atg;
  }
  __syncthreads();

  const size_t out_base = ((size_t)b * num_scales + s) * h * w;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    float lm = rowmax[r * kTile + c];
    for (int d = 1; d <= 2 * nr; ++d) lm = fmaxf(lm, rowmax[(r + d) * kTile + c]);
    const float v = resp[(r + nr) * RS + c + nr];
    const float kept = mul(v, (v == lm && v > thr) ? 1.f : 0.f);
    const size_t o = out_base + (size_t)gy * w + gx;
    score[o] = kept < 0.f ? 0.f : kept;

    float a10 = 0.f, a01 = 0.f;
    bool any10 = false, any01 = false;
    for (int t = 0; t < nt; ++t) {
      if (tg[t] != 0.f) { const float v10 = mul(tg[t], vg[r * MW + c + t]); a10 = any10 ? add(a10, v10) : v10; any10 = true; }
      if (g[t] != 0.f) { const float v01 = mul(g[t], vtg[r * MW + c + t]); a01 = any01 ? add(a01, v01) : v01; any01 = true; }
    }
    m10[o] = a10;
    m01[o] = a01;
  }
}

}  // namespace

// image (b, h, w) f32 -> score, m10, m01 (b, num_scales, h, w). taps holds
// the 2*half+1 Gaussian taps g, then t*g. buf0, buf1 (b, h, w) are scratch
// for the diffusion state. Returns the first non-zero cudaGetLastError()
// among the launches, else 0.
extern "C" int oip_akaze_ladder(const float* image, const float* taps,
                                float* buf0, float* buf1, float* score,
                                float* m10, float* m01, int b, int h, int w,
                                int num_scales, int iters, float inv_k2,
                                float thr, int nms_radius, int half,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  const int hl = nms_radius + 1 > half ? nms_radius + 1 : half;
  const size_t ls = kTile + 2 * hl, rs = kTile + 2 * nms_radius, mw = kTile + 2 * half;
  const size_t smem = sizeof(float) * (ls * ls + rs * rs + rs * kTile +
                                       2 * kTile * mw + 2 * (2 * half + 1));
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(scale_out_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* cur = image;
  for (int s = 0; s < num_scales; ++s) {
    for (int it = 0; it < iters; ++it) {
      float* next = cur == buf0 ? buf1 : buf0;
      fed_step_kernel<<<grid, kThreads, 0, st>>>(cur, next, h, w, inv_k2);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      cur = next;
    }
    scale_out_kernel<<<grid, kThreads, smem, st>>>(cur, taps, score, m10, m01, h, w,
                                                   s, num_scales, thr, nms_radius, half);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
