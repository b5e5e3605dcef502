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
// What bounds it on this card: ~60 operations per pixel per FED step over a
// state that is 2.4 MB for a 480x640 pair. The card's bytes bound (the
// image read once, 3 maps per scale written once) is ~7 us; one launch per
// step, each reading and writing the whole state through L2, costs ~13 us a
// launch in latency and tails. On the TPU the whole ladder stays in VMEM.
// One image does not fit one CTA's shared memory, but the card's 132 SMs
// hold ~30 MB of it together.
// Design (the resident route): one cooperative launch. Each CTA owns a
// tile of one image (bands or blocks of rows and columns, laid out by
// kernels/akaze_ladder.py ladder_plan, every tile at least the halo deep)
// and keeps L of its tile plus a halo in shared memory for every step and
// scale. After a step a CTA writes the border ring of its tile (2 pixels
// deep; the halo's depth after the last step of a scale) to a mirror of the
// state in device memory, one of two by the step's parity, then raises its
// tag to the step's number; it waits on the tags of its (up to 8)
// neighbours only, and reads its halo back from the mirror. A mirror slot
// is rewritten two steps later, after its writer has waited on every
// neighbour's next step, which each neighbour publishes only after reading
// the slot. A spin that outlasts any real wait traps. The tags are cleared
// by the launch's one grid.sync(). The scale outputs are computed from the
// resident L in row chunks (the whole tile where shared memory allows), and
// each output pixel is written once.
// The global route, for states that shared memory cannot hold (the plan
// picks it by shape): one launch per FED step (a 32x32 tile plus a 2-pixel
// halo of L in shared memory, two ping-pong state buffers), then one launch
// per scale for its outputs. Both routes share the arithmetic below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;          // global route: tile side
constexpr int kThreads = 256;      // global route: threads per CTA
constexpr int kResThreads = 1024;  // resident route: threads per CTA
constexpr int kMaxSmem = 232448;   // opt-in shared memory per CTA
constexpr int kMaxDevices = 64;
// Polls of a neighbour's tag before the kernel gives up (~seconds; a real
// wait is microseconds, since every CTA of the launch is resident).
constexpr unsigned kMaxPolls = 1u << 24;

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

// The fluxes c*gx, c*gy at the centre of the 3x3 window p.
__device__ __forceinline__ void flux(const float* p, int ld, float inv_k2, float* cgx,
                                     float* cgy) {
  const float gx = sobel_x(p, ld), gy = sobel_y(p, ld);
  const float mag2 = add(add(mul(gx, gx), mul(gy, gy)), 1e-8f);
  const float cc = __fdiv_rn(1.f, add(1.f, mul(mag2, inv_k2)));
  *cgx = mul(cc, gx);
  *cgy = mul(cc, gy);
}

// Hessian response at the centre of the 3x3 window p: lxx = outer([1,2,1],
// [1,-2,1]) / 16, lyy = outer([1,-2,1], [1,2,1]) / 16, lxy = outer([1,0,-1],
// [1,0,-1]) / 4.
__device__ __forceinline__ float hessian(const float* p, int ld) {
  float a[3], c[3], d[3];
  for (int k = 0; k < 3; ++k) {
    a[k] = add(add(p[k], mul(2.f, p[ld + k])), p[2 * ld + k]);
    c[k] = add(add(p[k], mul(-2.f, p[ld + k])), p[2 * ld + k]);
    d[k] = add(p[k], -p[2 * ld + k]);
  }
  const float lxx = mul(add(add(a[0], mul(-2.f, a[1])), a[2]), 0.0625f);
  const float lyy = mul(add(add(c[0], mul(2.f, c[1])), c[2]), 0.0625f);
  const float lxy = mul(add(d[0], -d[2]), 0.25f);
  return __fsub_rn(mul(lxx, lyy), mul(lxy, lxy));
}

// Vertical moment passes down the column col (entries ld apart), nt taps
// each of g and tg, zero taps skipped.
__device__ __forceinline__ void vertical_moments(const float* col, int ld, const float* g,
                                                 const float* tg, int nt, float* ag,
                                                 float* atg) {
  float sg = 0.f, stg = 0.f;
  bool any_g = false, any_tg = false;
  for (int t = 0; t < nt; ++t) {
    const float x = col[t * ld];
    if (g[t] != 0.f) { const float v = mul(g[t], x); sg = any_g ? add(sg, v) : v; any_g = true; }
    if (tg[t] != 0.f) { const float v = mul(tg[t], x); stg = any_tg ? add(stg, v) : v; any_tg = true; }
  }
  *ag = sg;
  *atg = stg;
}

// Horizontal moment passes: m10 = tg over the g-pass row, m01 = g over the
// tg-pass row.
__device__ __forceinline__ void horizontal_moments(const float* rg, const float* rtg,
                                                   const float* g, const float* tg, int nt,
                                                   float* m10, float* m01) {
  float a10 = 0.f, a01 = 0.f;
  bool any10 = false, any01 = false;
  for (int t = 0; t < nt; ++t) {
    if (tg[t] != 0.f) { const float v = mul(tg[t], rg[t]); a10 = any10 ? add(a10, v) : v; any10 = true; }
    if (g[t] != 0.f) { const float v = mul(g[t], rtg[t]); a01 = any01 ? add(a01, v) : v; any01 = true; }
  }
  *m10 = a10;
  *m01 = a01;
}

// The NMS score: the response where it equals its window max and passes the
// threshold, clamped at 0.
__device__ __forceinline__ float nms_score(float v, float local_max, float thr) {
  const float kept = mul(v, (v == local_max && v > thr) ? 1.f : 0.f);
  return kept < 0.f ? 0.f : kept;
}

// ---------------------------------------------------------------------------
// The global route.

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
    if (inside(y0 - 1 + r, x0 - 1 + c, h, w)) flux(ls + r * LS + c, LS, inv_k2, &cgx, &cgy);
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

  for (int i = threadIdx.x; i < RS * RS; i += blockDim.x) {
    const int ri = i / RS, ci = i % RS;
    resp[i] = inside(y0 - nr + ri, x0 - nr + ci, h, w)
                  ? hessian(ls + (ri - nr + hl - 1) * LS + (ci - nr + hl - 1), LS) : 0.f;
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
    vertical_moments(ls + (r - half + hl) * LS + (j - half + hl), LS, g, tg, nt, vg + i, vtg + i);
  }
  __syncthreads();

  const size_t out_base = ((size_t)b * num_scales + s) * h * w;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    float lm = rowmax[r * kTile + c];
    for (int d = 1; d <= 2 * nr; ++d) lm = fmaxf(lm, rowmax[(r + d) * kTile + c]);
    const size_t o = out_base + (size_t)gy * w + gx;
    score[o] = nms_score(resp[(r + nr) * RS + c + nr], lm, thr);
    horizontal_moments(vg + r * MW + c, vtg + r * MW + c, g, tg, nt, m10 + o, m01 + o);
  }
}

// ---------------------------------------------------------------------------
// The resident route.

// Halo of L a tile keeps: the FED step's 2, the response's nr + 1 and the
// moments' half-width.
__host__ __device__ inline int ladder_halo(int nr, int half) {
  const int a = nr + 1 > half ? nr + 1 : half;
  return a > 2 ? a : 2;
}

// Floats of dynamic shared memory for tiles of at most th x tw pixels whose
// scale outputs go in chunks of oc rows: L with its halo; then, in turn, the
// fluxes of a FED step or one chunk of the scale outputs (response, row
// maxima, two vertical moment passes); then the taps.
// kernels/akaze_ladder.py _resident_floats computes the same.
__host__ __device__ inline size_t resident_floats(int th, int tw, int nr, int half, int oc) {
  const int hh = ladder_halo(nr, half);
  const size_t l = (size_t)(th + 2 * hh) * (tw + 2 * hh);
  const size_t fed = 2 * (size_t)(th + 2) * (tw + 2);
  const size_t out = (size_t)(oc + 2 * nr) * (tw + 2 * nr) + (size_t)(oc + 2 * nr) * tw +
                     2 * (size_t)oc * (tw + 2 * half);
  return l + (fed > out ? fed : out) + 2 * (2 * half + 1);
}

// First row (or column) of tile i of n over size pixels: balanced spans.
__host__ __device__ inline int span_lo(int i, int n, int size) {
  return (int)((long long)i * size / n);
}

struct Tile {
  int y0, x0, th, tw, hh, ls;   // origin, size, halo, row stride of L in shared memory
};

// Rows of a loop go to warps, columns to lanes: no divisions per cell.
__device__ __forceinline__ int warp_id() { return threadIdx.x / 32; }
__device__ __forceinline__ int lane_id() { return threadIdx.x % 32; }
constexpr int kResWarps = kResThreads / 32;

// One FED step of the tile, in place on L (its halo 2 deep holds the step
// before's values of the neighbours' pixels).
__device__ void resident_fed_step(float* L, float* work, const Tile& t, int h, int w,
                                  float inv_k2) {
  const int fs = t.tw + 2, fr = t.th + 2;
  float* fx = work;
  float* fy = work + fr * fs;
  for (int r = warp_id(); r < fr; r += kResWarps) {   // pixel row r - 1 of the tile
    const bool row_in = t.y0 - 1 + r >= 0 && t.y0 - 1 + r < h;
    for (int c = lane_id(); c < fs; c += 32) {
      float cgx = 0.f, cgy = 0.f;
      if (row_in && t.x0 - 1 + c >= 0 && t.x0 - 1 + c < w)
        flux(L + (r + t.hh - 2) * t.ls + (c + t.hh - 2), t.ls, inv_k2, &cgx, &cgy);
      fx[r * fs + c] = cgx;
      fy[r * fs + c] = cgy;
    }
  }
  __syncthreads();
  for (int r = warp_id(); r < t.th; r += kResWarps)
    for (int c = lane_id(); c < t.tw; c += 32) {
      const float div = add(sobel_x(fx + r * fs + c, fs), sobel_y(fy + r * fs + c, fs));
      float* l = L + (r + t.hh) * t.ls + c + t.hh;
      *l = add(*l, mul(0.25f, div));
    }
  __syncthreads();
}

// Cell i of the ring `d` deep just inside (d > 0) or just outside (d < 0)
// the edge of a th x tw box, as (row, column) relative to the box: the top
// rows, the bottom rows, then the two side strips of the rows between.
// ring_cells counts them.
__device__ __forceinline__ int ring_cells(int th, int tw, int d) {
  return d > 0 ? (2 * d >= th || 2 * d >= tw ? th * tw : 2 * d * tw + (th - 2 * d) * 2 * d)
               : -2 * d * (tw - 2 * d) + th * -2 * d;
}

__device__ __forceinline__ void ring_cell(int i, int th, int tw, int d, int* r, int* c) {
  if (d > 0 && (2 * d >= th || 2 * d >= tw)) {   // a small tile's ring is all of it
    *r = i / tw;
    *c = i % tw;
    return;
  }
  const int dd = d > 0 ? d : -d;
  const int x0 = d > 0 ? 0 : -dd, wr = d > 0 ? tw : tw + 2 * dd;   // the full rows
  const int top = dd * wr;
  if (i < 2 * top) {
    const int j = i < top ? i : i - top;
    *r = (i < top ? (d > 0 ? 0 : -dd) : (d > 0 ? th - dd : th)) + j / wr;
    *c = x0 + j % wr;
  } else {
    const int j = i - 2 * top, k = j % (2 * dd);
    *r = (d > 0 ? dd : 0) + j / (2 * dd);
    *c = k < dd ? x0 + k : (d > 0 ? tw - 2 * dd + k : tw + k - dd);
  }
}

// The tile's border ring, depth pixels deep, into the mirror (past L1).
__device__ void publish_ring(const float* L, float* mirror, const Tile& t, int w, int depth) {
  const int n = ring_cells(t.th, t.tw, depth);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r, c;
    ring_cell(i, t.th, t.tw, depth, &r, &c);
    __stcg(mirror + (size_t)(t.y0 + r) * w + t.x0 + c, L[(r + t.hh) * t.ls + c + t.hh]);
  }
}

// Wait until every neighbouring tile (of the 3x3 around this one) has
// published step `step`. Every thread of the CTA must call it.
__device__ void wait_neighbours(const unsigned* tags, int b, int ty, int tx, int ny, int nx,
                                unsigned step) {
  const int tid = threadIdx.x;
  if (tid < 9 && tid != 4) {
    const int qy = ty + tid / 3 - 1, qx = tx + tid % 3 - 1;
    if (qy >= 0 && qy < ny && qx >= 0 && qx < nx) {
      const volatile unsigned* tag = tags + ((size_t)b * ny + qy) * nx + qx;
      unsigned polls = 0;
      while (*tag < step)
        if (++polls == kMaxPolls) __trap();
      __threadfence();
    }
  }
  __syncthreads();
}

// The halo ring of L, depth pixels deep, from the mirror (past L1: the
// same addresses were read two steps before).
__device__ void read_halo(float* L, const float* mirror, const Tile& t, int h, int w,
                          int depth) {
  const int n = ring_cells(t.th, t.tw, -depth);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r, c;
    ring_cell(i, t.th, t.tw, -depth, &r, &c);
    const int gy = t.y0 + r, gx = t.x0 + c;
    if (inside(gy, gx, h, w))
      L[(r + t.hh) * t.ls + c + t.hh] = __ldcg(mirror + (size_t)gy * w + gx);
  }
  __syncthreads();
}

// Rows of the moment passes a thread takes at once: independent chains of
// multiplies and adds, which hide each other's latency.
constexpr int kMomentRows = 4;
constexpr int kMaxTaps = 31;   // 2 * 15 + 1: the wrapper's largest patch

// The moment taps as a kernel parameter: with the tap count known at
// compile time (NT > 0) each tap is an operand of its multiply, read from
// the constant bank instead of shared memory.
struct Taps {
  float g[kMaxTaps];
  float tg[kMaxTaps];
};

// score, m10, m01 of the tile from the resident L (its halo hh deep holds
// this step's values), in chunks of out_rows rows; the output pointers are
// at [b, s] of the (B, S, H, W) maps. NT: the tap count if fixed at compile
// time (taps from tp, loops unrolled), else 0 (taps from g and tg in
// shared memory).
template <int NT>
__device__ void resident_scale_out(const float* L, float* work, const Taps& tp, const float* g,
                                   const float* tg, const Tile& t, int h, int w, int nr,
                                   int half, float thr, int out_rows, float* score, float* m10,
                                   float* m01) {
  const int rs = t.tw + 2 * nr, mw = t.tw + 2 * half, nt = NT > 0 ? NT : 2 * half + 1;
  const int oc = t.th < out_rows ? t.th : out_rows;
  float* resp = work;                         // (oc + 2 nr) x rs, 0 outside the image
  float* rowmax = resp + (oc + 2 * nr) * rs;  // (oc + 2 nr) x tw
  float* vg = rowmax + (oc + 2 * nr) * t.tw;  // oc x mw
  float* vtg = vg + oc * mw;                  // oc x mw
  for (int r0 = 0; r0 < t.th; r0 += oc) {
    const int rows = min(oc, t.th - r0), rr = rows + 2 * nr;
    for (int i = warp_id(); i < rr; i += kResWarps) {
      const int py = r0 - nr + i;   // tile row
      const bool row_in = t.y0 + py >= 0 && t.y0 + py < h;
      for (int j = lane_id(); j < rs; j += 32) {
        const int px = j - nr;
        resp[i * rs + j] = row_in && t.x0 + px >= 0 && t.x0 + px < w
                               ? hessian(L + (py - 1 + t.hh) * t.ls + (px - 1 + t.hh), t.ls)
                               : 0.f;
      }
    }
    __syncthreads();
    for (int i = warp_id(); i < rr; i += kResWarps)
      for (int c = lane_id(); c < t.tw; c += 32) {
        const float* row = resp + i * rs + c;
        float m = row[0];
        for (int d = 1; d <= 2 * nr; ++d) m = fmaxf(m, row[d]);
        rowmax[i * t.tw + c] = m;
      }
    // Vertical moment passes, kMomentRows rows of one column per thread.
    const int groups = (rows + kMomentRows - 1) / kMomentRows;
    for (int u = threadIdx.x; u < groups * mw; u += blockDim.x) {
      const int r = (u / mw) * kMomentRows, j = u % mw;
      const float* col = L + (r0 + r - half + t.hh) * t.ls + (j - half + t.hh);
      float sg[kMomentRows], stg[kMomentRows];
      bool any_g = false, any_tg = false;
      for (int q = 0; q < kMomentRows; ++q) sg[q] = stg[q] = 0.f;
#pragma unroll
      for (int k = 0; k < (NT > 0 ? NT : nt); ++k) {
        float gk, tk;
        if constexpr (NT > 0) {
          gk = tp.g[k];
          tk = tp.tg[k];
        } else {
          gk = g[k];
          tk = tg[k];
        }
#pragma unroll
        for (int q = 0; q < kMomentRows; ++q) {
          const float x = col[(k + q) * t.ls];   // rows past the chunk read the halo; unused
          if (gk != 0.f) { const float v = mul(gk, x); sg[q] = any_g ? add(sg[q], v) : v; }
          if (tk != 0.f) { const float v = mul(tk, x); stg[q] = any_tg ? add(stg[q], v) : v; }
        }
        any_g |= gk != 0.f;
        any_tg |= tk != 0.f;
      }
#pragma unroll
      for (int q = 0; q < kMomentRows; ++q)
        if (r + q < rows) {
          vg[(r + q) * mw + j] = sg[q];
          vtg[(r + q) * mw + j] = stg[q];
        }
    }
    __syncthreads();
    for (int u = threadIdx.x; u < groups * t.tw; u += blockDim.x) {
      const int r = (u / t.tw) * kMomentRows, c = u % t.tw;
      float a10[kMomentRows], a01[kMomentRows];
      bool any10 = false, any01 = false;
      for (int q = 0; q < kMomentRows; ++q) a10[q] = a01[q] = 0.f;
#pragma unroll
      for (int k = 0; k < (NT > 0 ? NT : nt); ++k) {
        float gk, tk;
        if constexpr (NT > 0) {
          gk = tp.g[k];
          tk = tp.tg[k];
        } else {
          gk = g[k];
          tk = tg[k];
        }
#pragma unroll
        for (int q = 0; q < kMomentRows; ++q) {
          const int row = min(r + q, rows - 1);
          if (tk != 0.f) { const float v = mul(tk, vg[row * mw + c + k]); a10[q] = any10 ? add(a10[q], v) : v; }
          if (gk != 0.f) { const float v = mul(gk, vtg[row * mw + c + k]); a01[q] = any01 ? add(a01[q], v) : v; }
        }
        any10 |= tk != 0.f;
        any01 |= gk != 0.f;
      }
#pragma unroll
      for (int q = 0; q < kMomentRows; ++q) {
        if (r + q >= rows) break;
        const int rq = r + q;
        float lm = rowmax[rq * t.tw + c];
        for (int d = 1; d <= 2 * nr; ++d) lm = fmaxf(lm, rowmax[(rq + d) * t.tw + c]);
        const size_t o = (size_t)(t.y0 + r0 + rq) * w + t.x0 + c;
        score[o] = nms_score(resp[(rq + nr) * rs + c + nr], lm, thr);
        m10[o] = a10[q];
        m01[o] = a01[q];
      }
    }
    __syncthreads();
  }
}

template <int NT>
__global__ void __launch_bounds__(kResThreads)
ladder_resident_kernel(const float* __restrict__ image, const __grid_constant__ Taps taps,
                       float* mirror, unsigned* tags, float* __restrict__ score,
                       float* __restrict__ m10, float* __restrict__ m01, int h, int w, int ny,
                       int nx, int num_scales, int iters, float inv_k2, float thr, int nr,
                       int half, int out_rows) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z, nb = gridDim.z;
  const int th_max = (h + ny - 1) / ny, tw_max = (w + nx - 1) / nx;
  Tile t;
  t.y0 = span_lo(ty, ny, h);
  t.x0 = span_lo(tx, nx, w);
  t.th = span_lo(ty + 1, ny, h) - t.y0;
  t.tw = span_lo(tx + 1, nx, w) - t.x0;
  t.hh = ladder_halo(nr, half);
  t.ls = t.tw + 2 * t.hh;
  const int nt = 2 * half + 1;
  const size_t l_floats = (size_t)(th_max + 2 * t.hh) * (tw_max + 2 * t.hh);
  float* L = smem;
  float* work = smem + l_floats;
  float* g = smem + resident_floats(th_max, tw_max, nr, half, out_rows) - 2 * nt;
  float* tg = g + nt;
  const size_t plane = (size_t)h * w;
  const float* img = image + b * plane;

  // Tags run 1..num_scales * iters in each launch: clear this CTA's first.
  if (threadIdx.x == 0) tags[((size_t)b * ny + ty) * nx + tx] = 0u;
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    g[i] = taps.g[i];
    tg[i] = taps.tg[i];
  }
  const int lr = t.th + 2 * t.hh;
  for (int i = threadIdx.x; i < lr * t.ls; i += blockDim.x) {
    const int gy = t.y0 - t.hh + i / t.ls, gx = t.x0 - t.hh + i % t.ls;
    L[i] = inside(gy, gx, h, w) ? img[(size_t)gy * w + gx] : 0.f;
  }
  grid.sync();

  unsigned step = 0;
  for (int s = 0; s < num_scales; ++s) {
    for (int it = 0; it < iters; ++it) {
      ++step;
      resident_fed_step(L, work, t, h, w, inv_k2);
      // The last step of a scale also feeds the scale's outputs: its ring
      // is as deep as their halo.
      const int depth = it == iters - 1 ? t.hh : 2;
      float* mir = mirror + ((step & 1u) * nb + b) * plane;
      publish_ring(L, mir, t, w, depth);
      // The CTA's ring stores, then one fence and the tag (as a grid
      // barrier releases a CTA's writes).
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        *(volatile unsigned*)(tags + ((size_t)b * ny + ty) * nx + tx) = step;
      }
      wait_neighbours(tags, b, ty, tx, ny, nx, step);
      read_halo(L, mir, t, h, w, depth);
    }
    const size_t out = ((size_t)b * num_scales + s) * plane;
    resident_scale_out<NT>(L, work, taps, g, tg, t, h, w, nr, half, thr, out_rows,
                           score + out, m10 + out, m01 + out);
  }
}

// The plan's arguments are those of ladder_plan; anything else is refused.
bool resident_plan_ok(int b, int h, int w, int nr, int half, int ny, int nx, int out_rows,
                      int smem) {
  const int hh = ladder_halo(nr, half), th = (h + ny - 1) / ny;
  return b > 0 && h > 0 && w > 0 && ny >= 1 && ny <= h && nx >= 1 && nx <= w &&
         (ny == 1 || h / ny >= hh) && (nx == 1 || w / nx >= hh) && out_rows >= 1 &&
         out_rows <= th && smem <= kMaxSmem &&
         (size_t)smem == sizeof(float) * resident_floats(th, (w + nx - 1) / nx, nr, half,
                                                         out_rows);
}

// The default patch (15 taps) has its own instantiation, unrolled.
constexpr int kFixedTaps = 15;

// Raises the resident kernels' dynamic shared memory limit on the current
// device to at least smem (an attribute is set per device; each is set once).
cudaError_t set_smem(int smem) {
  static int smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && smem <= smem_set[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(ladder_resident_kernel<kFixedTaps>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ladder_resident_kernel<0>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices) smem_set[device] = smem;
  return err;
}

}  // namespace

// image (b, h, w) f32 -> score, m10, m01 (b, num_scales, h, w), the global
// route. taps holds the 2*half+1 Gaussian taps g, then t*g. buf0, buf1
// (b, h, w) are scratch for the diffusion state. Returns the first non-zero
// cudaGetLastError() among the launches, else 0.
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

// How many CTAs of the resident kernel for a patch of 2*half+1 taps with
// smem bytes of dynamic shared memory the current device holds at once (the
// cooperative launch needs all of them resident), in *resident.
extern "C" int oip_akaze_ladder_resident_ctas(int half, int smem, int* resident) {
  cudaError_t err = set_smem(smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm,
      2 * half + 1 == kFixedTaps ? ladder_resident_kernel<kFixedTaps> : ladder_resident_kernel<0>,
      kResThreads, (size_t)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *resident = per_sm * sms;
  return (int)err;
}

// The resident route, in one cooperative launch of b x ny x nx CTAs laid
// out by ladder_plan (tiles, and chunks of out_rows rows for the scale
// outputs): image and the outputs as oip_akaze_ladder; host_taps, in host
// memory, holds the 2*half+1 taps g, then t*g (half <= 15);
// mirror (2, b, h, w) f32 and tags (b, ny, nx) u32 are scratch. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a plan
// that is not ladder_plan's).
extern "C" int oip_akaze_ladder_resident(const float* image, const float* host_taps,
                                         float* mirror,
                                         unsigned* tags, float* score, float* m10, float* m01,
                                         int b, int h, int w, int num_scales, int iters,
                                         float inv_k2, float thr, int nms_radius, int half,
                                         int ny, int nx, int out_rows, int smem, void* stream) {
  const int nt = 2 * half + 1;
  if (num_scales < 1 || iters < 0 || half < 0 || nt > kMaxTaps ||
      !resident_plan_ok(b, h, w, nms_radius, half, ny, nx, out_rows, smem))
    return (int)cudaErrorInvalidValue;
  Taps taps = {};
  for (int i = 0; i < nt; ++i) {
    taps.g[i] = host_taps[i];
    taps.tg[i] = host_taps[nt + i];
  }
  cudaError_t err = set_smem(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nx, ny, b);
  cfg.blockDim = dim3(kResThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg,
                           nt == kFixedTaps ? ladder_resident_kernel<kFixedTaps>
                                            : ladder_resident_kernel<0>,
                           image, taps, mirror, tags, score, m10, m01, h, w, ny, nx, num_scales,
                           iters, inv_k2, thr, nms_radius, half, out_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
