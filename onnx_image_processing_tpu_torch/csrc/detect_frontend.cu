// Fused Shi-Tomasi score + NMS keep mask + orientation moments, the same
// pass with the NMS compiled out (the raw score and the moments), and the
// pass followed by the premasked block top-k, for Hopper (sm_90a).
//
// Replaces: onnx_image_processing_tpu/kernels/detect_frontend.py,
//   detect_frontend -> _detect_kernel (the Pallas TPU kernel), and, in
//   detect_select, the premasked select that follows it in
//   models/shi_tomasi_family.py _fused_detect_select; at NMS radius 0 (the
//   port's score_moments), the plain Shi-Tomasi and moment stencils of the
//   unfused route. Plain twins: detect_frontend_plain, score_moments_plain
//   and detect_select_plain in
//   onnx_image_processing_tpu_torch/kernels/detect_frontend.py.
//
// Computes, per pixel: the Shi-Tomasi lambda_min of the Sobel structure
// tensor summed over a block_size box, clamped at 0; the NMS keep mask
// `score >= local_max - 1e-7f` over a (2r+1)^2 window; the output
// score * keep (at NMS radius 0 every pixel keeps its score, so the kernels
// with RN = 0 skip the NMS stages and store the score as it comes); and,
// with_angle, the Gaussian moments m10, m01. Three border
// rules, each the twin's:
//   1. the Sobel reads the edge-replicated image;
//   2. the box sums read the edge-replicated PRODUCT maps, i.e. ix*ix etc.
//      taken at the clamped position, not products of Sobels of the
//      extended image;
//   3. the NMS window counts cells outside the image as -inf;
// and the moments read the zero-padded image. detect_select then applies
// the border-margin and threshold masks (multiply by 1.f or 0.f, then
// `x > thr ? x : 0`), takes every (r+1)x(r+1) block's max and minimum raster
// index, and the image's last CTA selects the K best blocks
// (select_topk.cuh, shared with select_frontend.cu).
//
// Arithmetic: every multiply, add and the square root are rounded on their
// own (__fmul_rn, __fadd_rn, __fsqrt_rn) in the twin's order (vertical
// taps, then horizontal, zero taps skipped, the first term of a sum being
// its first product), so nvcc contracts nothing into an fma and the kernel
// is bit-identical to its twin. No running sums: every window is summed
// term by term. The moment taps come from the caller (the twin's float32
// numpy values) by value, with a mask of the non-zero ones, so a zero tap
// (the centre of t*g) is skipped uniformly across threads.
//
// What bounds it on this card: one read of the image and three writes, 16 B
// a pixel, 2.93 us at 2 x 480 x 640 and 3.35 TB/s; the ~200 separately
// rounded operations per pixel (most in the two 15-tap moment passes) take
// about as long at the f32 issue rate, so the kernel sits near both.
// Design: one CTA of 512 threads per tile of whole NMS blocks, its size
// planned on the host (detect_plan in the wrapper: 24 x 108 at the flagship's
// radii and 2 x 480 x 640, two CTAs per SM, one wave) to cut the halo work
// of 32 x 32 tiles. The tile's clamped image with its halo arrives in one
// round of asynchronous copies. Vertical passes walk down a column, one
// thread a column and a segment of rows, kStep rows a step with the window
// in registers: the Sobel rows, the box's products (column sums computed
// once per column), the NMS column max (the rows a step's windows share
// reduced once) and the two moment columns. Horizontal passes read rows
// from shared memory, columns by lane and rows by warp, so no per-cell
// divide. Independent passes share a barrier interval (the Sobel/box
// columns with the moments' vertical pass, the box rows with the moments'
// horizontal pass). The flagship's radii with the usual zero taps (g none,
// t*g its centre) are template constants, so the tap loops unroll with no
// test per tap; other radii or taps run the general instantiation, which
// sums each output from shared memory and skips the zero taps by the mask.

#include <climits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "select_topk.cuh"

namespace {

using namespace oip_topk;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadius = 15;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;   // shared memory one CTA can use on Hopper
constexpr int kStep = 4;   // rows a column walk of the fixed instantiations takes per step

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__host__ __device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// The moment taps by value, and the masks of the non-zero ones (bit t).
struct Taps {
  float g[kMaxTaps];
  float tg[kMaxTaps];
  unsigned gmask, tgmask;
};

struct Args {
  const float* image;
  float* score;
  float* m10;
  float* m01;
  int h, w, rb, rn, half, with_angle;
  int th, tw;   // output rows and columns of a tile
  Taps taps;
};

// detect_select only.
struct SelectArgs {
  float* block_max;
  int* block_idx;
  unsigned* counters;
  unsigned long long* keys_global;
  float* kpts;
  float* kscores;
  int margin;
  float thr;
  int hb, wb, k, keys_stride;
};

// A tile's regions: the image with halo hi (ih x iw), the box's column sums
// on the score rows and the product columns (sr x pw, three maps), the
// score with the NMS halo (sr x sw) and the moments' vertical pass
// (th x mw, two maps).
struct Geo {
  int hi, ph, ih, iw, sr, sw, pw, mw;
};

__host__ __device__ inline Geo geometry(int rb, int rn, int half, int th, int tw) {
  Geo g;
  g.ph = rb + rn;
  g.hi = g.ph + 1 > half ? g.ph + 1 : half;
  g.ih = th + 2 * g.hi;
  g.iw = tw + 2 * g.hi;
  g.sr = th + 2 * rn;
  g.sw = tw + 2 * rn;
  g.pw = tw + 2 * g.ph;
  g.mw = tw + 2 * half;
  return g;
}

// Floats of shared memory: the image, the column sums, the moments'
// vertical pass. The score aliases the image, the NMS column maxima the
// column sums, and detect_select's masked tile the vertical pass.
__host__ __device__ inline size_t smem_floats(int rb, int rn, int half, int th, int tw) {
  const Geo g = geometry(rb, rn, half, th, tw);
  return (size_t)g.ih * g.iw + 3 * (size_t)g.sr * g.pw + 2 * (size_t)th * g.mw;
}

// A vertical pass over rows x cols: work items of 32 columns (by lane) and
// a segment of rows, enough items for every warp of the CTA.
struct Walk {
  int nch, nseg, len;
  __device__ Walk(int rows, int cols) {
    nch = (cols + 31) / 32;
    nseg = (kWarps + nch - 1) / nch;
    if (nseg > rows) nseg = rows;
    if (nseg < 1) nseg = 1;
    len = (rows + nseg - 1) / nseg;
  }
  __device__ int items() const { return nch * nseg; }
};

// ix = outer([1,2,1], [-1,0,1]), iy = outer([-1,0,1], [1,2,1]) of the 3x3
// window whose rows are r0, r1, r2 (three columns each), in the twin's
// order; then the three products.
template <class Row>
__device__ __forceinline__ void sobel_products(const Row& r0, const Row& r1, const Row& r2,
                                               float& xx, float& yy, float& xy) {
  const float v0 = add(add(r0[0], mul(2.f, r1[0])), r2[0]);
  const float v2 = add(add(r0[2], mul(2.f, r1[2])), r2[2]);
  const float ix = add(-v0, v2);
  const float u0 = add(-r0[0], r2[0]);
  const float u1 = add(-r0[1], r2[1]);
  const float u2 = add(-r0[2], r2[2]);
  const float iy = add(add(u0, mul(2.f, u1)), u2);
  xx = mul(ix, ix);
  yy = mul(iy, iy);
  xy = mul(ix, iy);
}

__device__ __forceinline__ float shi_tomasi(float sxx, float syy, float sxy) {
  const float half_trace = mul(add(sxx, syy), 0.5f);
  const float diff_half = mul(__fsub_rn(sxx, syy), 0.5f);
  const float disc = add(mul(diff_half, diff_half), mul(sxy, sxy));
  const float lam = __fsub_rn(half_trace, __fsqrt_rn(add(disc, 1e-10f)));
  return lam < 0.f ? 0.f : lam;
}

// The zero taps of the fixed instantiations, known at compile time: every g
// tap non-zero, t*g zero at its centre only. The host launches them only
// for taps with that pattern (every patch size and sigma the flagship uses).
template <int NT>
constexpr unsigned kAllTaps = (1u << NT) - 1u;
template <int NT>
constexpr unsigned kNoCentre = kAllTaps<NT> & ~(1u << (NT / 2));

// Sum of taps[t] * x(t) over the non-zero taps, t in order, the first term
// being the first product (the twin's conv1d); 0 if none. NT > 0: NT taps
// whose non-zero ones are CMASK; else nt taps whose non-zero ones are mask.
template <int NT, unsigned CMASK, class X>
__device__ __forceinline__ float tap_sum(const float* taps, unsigned mask, int nt, const X& x) {
  float acc = 0.f;
  bool started = false;
  if constexpr (NT > 0) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if ((CMASK >> t) & 1u) {
        const float v = mul(taps[t], x(t));
        acc = started ? add(acc, v) : v;
        started = true;
      }
    }
  } else {
    for (int t = 0; t < nt; ++t) {
      if ((mask >> t) & 1u) {
        const float v = mul(taps[t], x(t));
        acc = started ? add(acc, v) : v;
        started = true;
      }
    }
  }
  return acc;
}

// The box's column sums of the three products, column j of the product
// columns (x = x0 - ph + j), score rows [s0, s1) (y = y0 - rn + row):
// cs(y) = sum over dy of P(clamp(y - rb + dy)) at the clamped column.
template <int RB>
__device__ void box_column(const float* img, float* cs, const Geo& G, int rb, int h, int w,
                           int y0, int x0, int j, int s0, int s1) {
  const int sx = clampi(x0 - G.ph + j, 0, w - 1) - x0 + G.hi - 1;   // left column of the Sobel
  const size_t plane = (size_t)G.sr * G.pw;
  auto centre = [&](int q) {   // smem row of the Sobel centre of product row q
    return clampi(y0 - G.ph + q, 0, h - 1) - y0 + G.hi;
  };
  auto product = [&](int q, float& xx, float& yy, float& xy) {   // product row q
    const float* p = img + (centre(q) - 1) * G.iw + sx;
    sobel_products(p, p + G.iw, p + 2 * G.iw, xx, yy, xy);
  };
  if constexpr (RB >= 0) {
    // kStep output rows a step; the window holds the products of rows
    // r0 .. r0 + kStep + 2 RB - 1, the first 2 RB kept from the step before.
    constexpr int BW = 2 * RB + 1, NP = kStep + 2 * RB;
    float pxx[NP], pyy[NP], pxy[NP];
#pragma unroll
    for (int d = 0; d < 2 * RB; ++d) product(s0 + d, pxx[kStep + d], pyy[kStep + d], pxy[kStep + d]);
    for (int r0 = s0; r0 < s1; r0 += kStep) {
#pragma unroll
      for (int d = 0; d < 2 * RB; ++d) {
        pxx[d] = pxx[kStep + d];
        pyy[d] = pyy[kStep + d];
        pxy[d] = pxy[kStep + d];
      }
      const int q0 = r0 + 2 * RB;   // the step's first new product row
      if (r0 + kStep <= s1 && centre(q0 + kStep - 1) - centre(q0) == kStep - 1) {
        // No clamped row: the step's kStep + 2 image rows, each read once.
        const float* p = img + (centre(q0) - 1) * G.iw + sx;
        float a[kStep + 2][3];
#pragma unroll
        for (int i = 0; i < kStep + 2; ++i)
#pragma unroll
          for (int c = 0; c < 3; ++c) a[i][c] = p[i * G.iw + c];
#pragma unroll
        for (int i = 0; i < kStep; ++i)
          sobel_products(a[i], a[i + 1], a[i + 2], pxx[2 * RB + i], pyy[2 * RB + i],
                         pxy[2 * RB + i]);
      } else {
#pragma unroll
        for (int i = 0; i < kStep; ++i)
          if (r0 + i < s1) product(q0 + i, pxx[2 * RB + i], pyy[2 * RB + i], pxy[2 * RB + i]);
      }
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        if (r0 + i >= s1) break;
        float sxx = pxx[i], syy = pyy[i], sxy = pxy[i];
#pragma unroll
        for (int d = 1; d < BW; ++d) {
          sxx = add(sxx, pxx[i + d]);
          syy = add(syy, pyy[i + d]);
          sxy = add(sxy, pxy[i + d]);
        }
        const size_t o = (size_t)(r0 + i) * G.pw + j;
        cs[o] = sxx;
        cs[o + plane] = syy;
        cs[o + 2 * plane] = sxy;
      }
    }
  } else {
    for (int r = s0; r < s1; ++r) {
      float sxx = 0.f, syy = 0.f, sxy = 0.f;
      for (int d = 0; d <= 2 * rb; ++d) {
        float xx, yy, xy;
        product(r + d, xx, yy, xy);
        sxx = d ? add(sxx, xx) : xx;
        syy = d ? add(syy, yy) : yy;
        sxy = d ? add(sxy, xy) : xy;
      }
      const size_t o = (size_t)r * G.pw + j;
      cs[o] = sxx;
      cs[o + plane] = syy;
      cs[o + 2 * plane] = sxy;
    }
  }
}

// The moments' vertical pass, column j (x = x0 - half + j), output rows
// [s0, s1): vg = sum g[t] Z(y0 + r - half + t), vtg with t*g, Z the
// zero-padded image.
template <int HALF>
__device__ void moment_column(const float* img, float* vg, float* vtg, const Geo& G,
                              const Taps& tp, int half, int h, int w, int y0, int x0, int j,
                              int s0, int s1) {
  const int x = x0 - half + j;
  const bool col_in = x >= 0 && x < w;
  const int sxc = j - half + G.hi;   // smem column of x
  // Z at window row i (image row y0 + i - half).
  auto z = [&](int i) {
    const int y = y0 + i - half;
    return col_in && y >= 0 && y < h ? img[(i - half + G.hi) * G.iw + sxc] : 0.f;
  };
  if constexpr (HALF >= 0) {
    // kStep output rows a step; the window holds Z of rows r0 .. r0 + kStep
    // + NT - 2, the first NT - 1 kept from the step before.
    constexpr int NT = 2 * HALF + 1;
    float win[NT + kStep - 1];
#pragma unroll
    for (int t = 0; t + 1 < NT; ++t) win[kStep + t] = z(s0 + t);
    for (int r0 = s0; r0 < s1; r0 += kStep) {
#pragma unroll
      for (int t = 0; t + 1 < NT; ++t) win[t] = win[kStep + t];
#pragma unroll
      for (int i = 0; i < kStep; ++i)
        if (r0 + i < s1) win[NT - 1 + i] = z(r0 + NT - 1 + i);
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        if (r0 + i >= s1) break;
        const int o = (r0 + i) * G.mw + j;
        vg[o] = tap_sum<NT, kAllTaps<NT>>(tp.g, 0u, NT, [&](int t) { return win[i + t]; });
        vtg[o] = tap_sum<NT, kNoCentre<NT>>(tp.tg, 0u, NT, [&](int t) { return win[i + t]; });
      }
    }
  } else {
    const int nt = 2 * half + 1;
    for (int r = s0; r < s1; ++r) {
      vg[r * G.mw + j] = tap_sum<0, 0u>(tp.g, tp.gmask, nt, [&](int t) { return z(r + t); });
      vtg[r * G.mw + j] = tap_sum<0, 0u>(tp.tg, tp.tgmask, nt, [&](int t) { return z(r + t); });
    }
  }
}

// The NMS window's column max, column c of the score (x = x0 - rn + c),
// output rows [s0, s1): the max of the 2rn+1 score rows from r.
template <int RN>
__device__ void max_column(const float* sc, float* colmax, const Geo& G, int rn, int c, int s0,
                           int s1) {
  if constexpr (RN >= 0) {
    // kStep output rows a step over a window of rows r0 .. r0 + kStep + NW
    // - 2: the max of the rows all kStep windows share, then each output's
    // own ends (max is exact, so any order gives the twin's value).
    constexpr int NW = 2 * RN + 1;
    static_assert(NW >= kStep, "the NMS window is at least a step deep");
    float win[NW + kStep - 1];
#pragma unroll
    for (int d = 0; d + 1 < NW; ++d) win[kStep + d] = sc[(s0 + d) * G.sw + c];
    for (int r0 = s0; r0 < s1; r0 += kStep) {
#pragma unroll
      for (int d = 0; d + 1 < NW; ++d) win[d] = win[kStep + d];
#pragma unroll
      for (int i = 0; i < kStep; ++i)
        if (r0 + i < s1) win[NW - 1 + i] = sc[(r0 + NW - 1 + i) * G.sw + c];
      float shared_max = win[kStep - 1];
#pragma unroll
      for (int d = kStep; d < NW; ++d) shared_max = fmaxf(shared_max, win[d]);
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        if (r0 + i >= s1) break;
        float m = shared_max;
#pragma unroll
        for (int d = i; d < kStep - 1; ++d) m = fmaxf(m, win[d]);
#pragma unroll
        for (int d = NW; d < NW + i; ++d) m = fmaxf(m, win[d]);
        colmax[(r0 + i) * G.sw + c] = m;
      }
    }
  } else {
    for (int r = s0; r < s1; ++r) {
      float m = sc[r * G.sw + c];
      for (int d = 1; d <= 2 * rn; ++d) m = fmaxf(m, sc[(r + d) * G.sw + c]);
      colmax[r * G.sw + c] = m;
    }
  }
}

// detect_select once the CTA's masked tile (th x tw, 0 past the image) is
// in shared memory: each block's max and the minimum raster index among its
// cells equal to it; then the image's last CTA selects the top k.
__device__ void select_tail(const float* masked, const SelectArgs& s, int rn, int w, int th,
                            int tw, int b, float* smem) {
  const int lane = lane_id(), warp = warp_id();
  const int bs = rn + 1, tby = th / bs, tbx = tw / bs;
  for (int by = warp; by < tby; by += kWarps) {
    const int oy = blockIdx.y * tby + by;
    if (oy >= s.hb) break;
    for (int bx = lane; bx < tbx; bx += 32) {
      const int ox = blockIdx.x * tbx + bx;
      if (ox >= s.wb) break;
      const float* cell = masked + by * bs * tw + bx * bs;
      float best = -INFINITY;
      for (int dy = 0; dy < bs; ++dy)
        for (int dx = 0; dx < bs; ++dx) best = fmaxf(best, cell[dy * tw + dx]);
      // Minimum index, not first in raster order: a block that overhangs the
      // right edge gives its pad cells indices past the row's end.
      int idx = INT_MAX;
      for (int dy = 0; dy < bs; ++dy)
        for (int dx = 0; dx < bs; ++dx)
          if (cell[dy * tw + dx] == best) idx = min(idx, (oy * bs + dy) * w + ox * bs + dx);
      const size_t o = ((size_t)b * s.hb + oy) * s.wb + ox;
      s.block_max[o] = best;
      s.block_idx[o] = idx;
    }
  }
  if (!last_of_image(s.counters, b, gridDim.x * gridDim.y)) return;
  const int n = s.hb * s.wb;
  select_phase<kThreads>(s.block_max + (size_t)b * n, s.block_idx + (size_t)b * n,
                         s.keys_global + (size_t)b * s.keys_stride, s.kpts + (size_t)b * s.k * 2,
                         s.kscores + (size_t)b * s.k, n, s.k, w, smem);
  if (threadIdx.x == 0) s.counters[b] = 0u;   // ready for the next launch
}

// One CTA per tile (blockIdx.x, blockIdx.y) of image blockIdx.z. RB, RN,
// HALF: the box radius, NMS radius and moment half-width as template
// constants, or -1 for the general kernel (read from a). RN = 0: no NMS
// stage, the score written in the row pass. SELECT: go on to the block
// maxima and the top-k (detect_select).
template <int RB, int RN, int HALF, bool SELECT>
__global__ void __launch_bounds__(kThreads, 2)
detect_kernel(const __grid_constant__ Args a, const __grid_constant__ SelectArgs s) {
  extern __shared__ float smem[];
  const int rb = RB >= 0 ? RB : a.rb, rn = RN >= 0 ? RN : a.rn, half = HALF >= 0 ? HALF : a.half;
  const int h = a.h, w = a.w, th = a.th, tw = a.tw;
  const Geo G = geometry(rb, rn, half, th, tw);
  float* img = smem;                                // ih x iw, edge-replicated image
  float* cs = img + (size_t)G.ih * G.iw;            // 3 x sr x pw column sums
  float* vg = cs + 3 * (size_t)G.sr * G.pw;         // th x mw
  float* vtg = vg + (size_t)th * G.mw;              // th x mw
  float* sc = img;                                  // sr x sw score, -inf outside
  float* colmax = cs;                               // th x sw
  float* masked = vg;                               // th x tw (detect_select)
  const int lane = lane_id(), warp = warp_id();
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * tw, b = blockIdx.z;
  const size_t base = (size_t)b * h * w;
  const float* src = a.image + base;
  constexpr bool kNms = RN != 0;
  static_assert(kNms || !SELECT, "the select needs the NMS stage");

  // 1. The clamped image with its halo (border rule 1).
  // Asynchronous copies: every load of the tile in flight at once.
  for (int r = warp; r < G.ih; r += kWarps) {
    const float* row = src + (size_t)clampi(y0 - G.hi + r, 0, h - 1) * w;
    for (int c = lane; c < G.iw; c += 32)
      __pipeline_memcpy_async(img + r * G.iw + c, row + clampi(x0 - G.hi + c, 0, w - 1),
                              sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. Column passes over the image: the box's column sums of the products
  //    at the clamped positions (border rule 2), and the moments' vertical
  //    pass of the zero-padded image.
  {
    const Walk box(G.sr, G.pw), mom(th, G.mw);
    const int n_box = box.items(), n_all = n_box + (a.with_angle ? mom.items() : 0);
    for (int it = warp; it < n_all; it += kWarps) {
      const bool is_box = it < n_box;
      const Walk& wk = is_box ? box : mom;
      const int u = is_box ? it : it - n_box;
      const int seg = u / wk.nch, j = (u - seg * wk.nch) * 32 + lane;
      const int s0 = seg * wk.len, s1 = min(s0 + wk.len, is_box ? G.sr : th);
      if (is_box) {
        if (j < G.pw) box_column<RB>(img, cs, G, rb, h, w, y0, x0, j, s0, s1);
      } else if (j < G.mw) {
        moment_column<HALF>(img, vg, vtg, G, a.taps, half, h, w, y0, x0, j, s0, s1);
      }
    }
  }
  __syncthreads();

  // 3. Row passes: the box's row sums and lambda_min, -inf outside the image
  //    (border rule 3), or without the NMS stage written out; the moments'
  //    horizontal pass, written out.
  const int bw = 2 * rb + 1;
  const size_t plane = (size_t)G.sr * G.pw;
  for (int r = warp; r < G.sr; r += kWarps) {
    const int y = y0 - rn + r;
    const bool row_in = y >= 0 && y < h;
    for (int c = lane; c < G.sw; c += 32) {
      const int x = x0 - rn + c;
      float v = -INFINITY;
      if (row_in && x >= 0 && x < w) {
        const float* p = cs + (size_t)r * G.pw + c;
        float sxx = p[0], syy = p[plane], sxy = p[2 * plane];
#pragma unroll
        for (int d = 1; d < (RB >= 0 ? 2 * RB + 1 : bw); ++d) {
          sxx = add(sxx, p[d]);
          syy = add(syy, p[plane + d]);
          sxy = add(sxy, p[2 * plane + d]);
        }
        v = shi_tomasi(sxx, syy, sxy);
        if constexpr (!kNms) a.score[base + (size_t)y * w + x] = v;
      }
      if constexpr (kNms) sc[r * G.sw + c] = v;
    }
  }
  if (a.with_angle) {
    const int nt = 2 * half + 1;
    constexpr int NT = HALF >= 0 ? 2 * HALF + 1 : 0;
      for (int r = warp; r < th && y0 + r < h; r += kWarps) {
      for (int c = lane; c < tw && x0 + c < w; c += 32) {
        const float* pg = vg + r * G.mw + c;
        const float* ptg = vtg + r * G.mw + c;
        const size_t o = base + (size_t)(y0 + r) * w + x0 + c;
        a.m10[o] = tap_sum<NT, kNoCentre<NT>>(a.taps.tg, a.taps.tgmask, nt,
                                              [&](int t) { return pg[t]; });
        a.m01[o] = tap_sum<NT, kAllTaps<NT>>(a.taps.g, a.taps.gmask, nt,
                                             [&](int t) { return ptg[t]; });
      }
    }
  }
  if constexpr (kNms) {
    __syncthreads();

    // 4. The NMS window's column maxima.
    {
      const Walk wk(th, G.sw);
      for (int u = warp; u < wk.items(); u += kWarps) {
        const int seg = u / wk.nch, c = (u - seg * wk.nch) * 32 + lane;
        const int s0 = seg * wk.len, s1 = min(s0 + wk.len, th);
        if (c < G.sw) max_column<RN>(sc, colmax, G, rn, c, s0, s1);
      }
    }
    __syncthreads();

    // 5. Row maxima, the keep mask, the masked score; detect_select also masks
    //    by the border margin and the threshold into the tile (0 past the
    //    image: the twin's zero padding of the last blocks), then selects.
    for (int r = warp; r < th; r += kWarps) {
      const int y = y0 + r;
      for (int c = lane; c < tw; c += 32) {
        const int x = x0 + c;
        float m = 0.f;
        if (y < h && x < w) {
          const float* cm = colmax + r * G.sw + c;
          float lm = cm[0];
#pragma unroll
          for (int d = 1; d <= (RN >= 0 ? 2 * RN : 2 * rn); ++d) lm = fmaxf(lm, cm[d]);
          const float v = sc[(r + rn) * G.sw + c + rn];
          m = mul(v, v >= __fsub_rn(lm, 1e-7f) ? 1.f : 0.f);
          a.score[base + (size_t)y * w + x] = m;
          if constexpr (SELECT) {
            if (s.margin > 0) {
              const bool inside = y >= s.margin && y < h - s.margin &&
                                  x >= s.margin && x < w - s.margin;
              m = mul(m, inside ? 1.f : 0.f);
            }
            m = m > s.thr ? m : 0.f;
          }
        }
        if constexpr (SELECT) masked[r * tw + c] = m;
      }
    }
    if constexpr (SELECT) {
      __syncthreads();
      select_tail(masked, s, rn, w, th, tw, b, smem);
    }
  }
}

using KernelFn = void (*)(Args, SelectArgs);

// The instantiations: the flagship's radii (box 2, NMS 5, moments 7: block
// 5, patch 15), box 1 with the same NMS and moments (block 3), both for the
// usual zero taps (kAllTaps, kNoCentre), and the general kernel; each alone
// and with the select; then the same three at NMS radius 0, and boxes 2 and
// 1 at NMS radius 0 with no moments (the halo the box's alone).
constexpr int kKernels = 11;
const KernelFn kKernelTable[kKernels] = {
    detect_kernel<2, 5, 7, false>, detect_kernel<2, 5, 7, true>,
    detect_kernel<1, 5, 7, false>, detect_kernel<1, 5, 7, true>,
    detect_kernel<-1, -1, -1, false>, detect_kernel<-1, -1, -1, true>,
    detect_kernel<2, 0, 7, false>, detect_kernel<1, 0, 7, false>,
    detect_kernel<-1, 0, -1, false>,
    detect_kernel<2, 0, 0, false>, detect_kernel<1, 0, 0, false>};

int kernel_index(const Args& a, bool select) {
  const int nt = 2 * a.half + 1;
  const unsigned all = (1u << nt) - 1u;
  const bool usual_taps = !a.with_angle ||
                          (a.taps.gmask == all && a.taps.tgmask == (all & ~(1u << a.half)));
  const int box = a.rb == 2 ? 0 : a.rb == 1 ? 1 : 2;   // box 2, box 1, other
  const int fixed = a.half == 7 && usual_taps ? box : 2;
  if (a.rn == 0) {   // the select needs rn >= 1
    if (box < 2 && !a.with_angle && a.half == 0) return 9 + box;
    return 6 + fixed;
  }
  return 2 * (a.rn == 5 ? fixed : 2) + (select ? 1 : 0);
}

// Raises kernel i's dynamic shared memory limit on the current device to at
// least smem (an attribute is set per device and kernel; each is set once).
cudaError_t set_smem(int i, size_t smem) {
  static size_t smem_set[kMaxDevices][kKernels] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (smem <= 48 * 1024 || (device < kMaxDevices && smem <= smem_set[device][i]))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kKernelTable[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && device < kMaxDevices) smem_set[device][i] = smem;
  return err;
}

// The common checks and arguments; false for what the kernel does not take.
bool make_args(Args* a, const float* image, const float* host_taps, float* score, float* m10,
               float* m01, int b, int h, int w, int rb, int rn, int half, int with_angle, int th,
               int tw) {
  const int bs = rn + 1, nt = 2 * half + 1;
  if (b < 1 || h < 1 || w < 1 || rb < 0 || rn < 0 || half < 0 || rb > kMaxRadius ||
      rn > kMaxRadius || half > kMaxRadius || th < bs || tw < bs || th % bs || tw % bs ||
      (with_angle && host_taps == nullptr) ||
      smem_floats(rb, rn, half, th, tw) * sizeof(float) > kMaxSmem)
    return false;
  *a = Args{};
  a->image = image;
  a->score = score;
  a->m10 = m10;
  a->m01 = m01;
  a->h = h;
  a->w = w;
  a->rb = rb;
  a->rn = rn;
  a->half = half;
  a->with_angle = with_angle;
  a->th = th;
  a->tw = tw;
  if (with_angle)
    for (int i = 0; i < nt; ++i) {
      a->taps.g[i] = host_taps[i];
      a->taps.tg[i] = host_taps[nt + i];
      a->taps.gmask |= (a->taps.g[i] != 0.f ? 1u : 0u) << i;
      a->taps.tgmask |= (a->taps.tg[i] != 0.f ? 1u : 0u) << i;
    }
  return true;
}

int launch(int i, const Args& a, const SelectArgs& s, int b, size_t smem, void* stream) {
  cudaError_t err = set_smem(i, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.w + a.tw - 1) / a.tw, (a.h + a.th - 1) / a.th, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kKernelTable[i], a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// image (b, h, w) f32 -> score (b, h, w) and, with_angle, m10, m01 (b, h, w).
// rb = block_size / 2, rn = NMS radius (0: the unmasked score, no NMS
// stage), half = patch_size / 2, each <= 15;
// host_taps, in host memory, holds the 2*half+1 Gaussian taps g, then t*g
// (read only with_angle). th x tw is the tile of one CTA (detect_plan):
// whole (rn+1)^2 blocks, within the card's shared memory. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int oip_detect_frontend(const float* image, const float* host_taps, float* score,
                                   float* m10, float* m01, int b, int h, int w, int rb, int rn,
                                   int half, int with_angle, int th, int tw, void* stream) {
  Args a;
  if (!make_args(&a, image, host_taps, score, m10, m01, b, h, w, rb, rn, half, with_angle, th,
                 tw))
    return (int)cudaErrorInvalidValue;
  return launch(kernel_index(a, false), a, SelectArgs{}, b,
                sizeof(float) * smem_floats(rb, rn, half, th, tw), stream);
}

// oip_detect_frontend, then in the same launch the border-margin and
// threshold masks, the (rn+1)^2 block maxima and the k largest of each
// image, decoded: kpts (b, k, 2) f32 (y, x) and kscores (b, k), as
// oip_select_topk on the masked score. Needs rn >= 1. block_max, block_idx
// (b, hb, wb) are scratch; counters (b) must be 0 before the first launch
// and are 0 again after each; keys_global holds keys_stride 64-bit keys per
// image (a power of two >= k) when k exceeds the shared-memory sort, else it
// is unused. Requires 1 <= k <= hb * wb.
extern "C" int oip_detect_select(const float* image, const float* host_taps, float* score,
                                 float* m10, float* m01, float* block_max, int* block_idx,
                                 unsigned* counters, unsigned long long* keys_global, float* kpts,
                                 float* kscores, int b, int h, int w, int rb, int rn, int half,
                                 int with_angle, int th, int tw, int margin, float thr, int k,
                                 int keys_stride, void* stream) {
  Args a;
  if (rn < 1 ||
      !make_args(&a, image, host_taps, score, m10, m01, b, h, w, rb, rn, half, with_angle, th,
                 tw))
    return (int)cudaErrorInvalidValue;
  SelectArgs s = {};
  s.hb = (h + rn) / (rn + 1);
  s.wb = (w + rn) / (rn + 1);
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  if (k < 1 || k > s.hb * s.wb ||
      (p2 > kSmemKeys && (keys_global == nullptr || keys_stride < p2)))
    return (int)cudaErrorInvalidValue;
  s.block_max = block_max;
  s.block_idx = block_idx;
  s.counters = counters;
  s.keys_global = keys_global;
  s.kpts = kpts;
  s.kscores = kscores;
  s.margin = margin;
  s.thr = thr;
  s.k = k;
  s.keys_stride = keys_stride;
  bool keys_in_smem, staged;
  const size_t sel = select_smem<kThreads>(s.hb * s.wb, k, &keys_in_smem, &staged);
  const size_t det = sizeof(float) * smem_floats(rb, rn, half, th, tw);
  const size_t smem = det > sel ? det : sel;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch(kernel_index(a, true), a, s, b, smem, stream);
}
