// Sparse BAD box sampler, for Hopper (sm_90a).
//
// Replaces: onnx_image_processing_tpu/kernels/sparse_sampler.py,
//   sparse_box_sample -> _sample_kernel_resident / _sample_kernel ->
//   _make_tile_compute (the Pallas TPU kernel). Plain twin: box_sample_plain
//   in onnx_image_processing_tpu_torch/kernels/sparse_sampler.py, the port of
//   reference_box_sample.
//
// Computes, for each keypoint, S box means of the replicate-padded image:
// the keypoint's window is the psi x psi slab (psi = ps + 2 r_max) of the
// padded image at (start_y, start_x), and sample j is the mean of the
// (2r+1)^2 box of its group's radius r centred at in-window coordinates
// (ly[j], lx[j]) -- rounded half to even (rintf, as torch.round and
// jnp.round) in nearest mode, two taps per axis in bilinear mode. Each box
// is summed along x, then along y, each in order, as the twin's
// shift-and-add bank is, so nearest mode matches the twin to the last bit;
// bilinear mode rounds each weight product on its own (__fmul_rn,
// __fadd_rn) in the twin's order, so it does too.
//
// What bounds it on this card: the box sums, ~36k shared-memory loads per
// keypoint at the 512-pair table (S = 805, radii 1..7) against ~30 KB of
// device-memory traffic, so shared-memory load throughput, not HBM; a
// warp's 32 boxes sit at random places in the window, so its loads meet
// 3-4-way bank conflicts. The first design also lost time to warps that
// straddled two radius groups (each box loop running to the larger
// radius), a last pass with 37 of 256 threads busy, an integer divide per
// window element, and four full box sums per bilinear sample.
// Design:
//   * one CTA of 8 warps per keypoint loads its 70 x 70 window (19.6 KB)
//     into shared memory by rows: a warp per row, lanes along x;
//   * one thread per sample sums its box in the twin's order; a warp takes
//     up to 32 samples of one radius group (a task), and the tasks are
//     dealt to the 8 warps by their loads, largest box first to the
//     least-loaded warp (the wrapper's sampler_plan);
//   * bilinear mode: the boxes at (y_lo, x) and (y_hi, x) share all but one
//     row, so each of the 2r+2 rows is summed once at x_lo and once at x_hi
//     and added into the taps that hold it: 2 (2r+2)(2r+1) loads instead
//     of 4 (2r+1)^2.
// Two other mappings were built and measured slower on an H100 (PERF.md,
// Findings): 2r+1 lanes per box, one per row (no bank conflicts within a box),
// whose row sums meet by 2r+1 shuffles, as many as its loads; and a
// per-keypoint bank-interleaved order of the samples (fewer conflicts in
// the box sums), whose ordering pass cost more than it saved.
// Measured (NVIDIA H100 80GB HBM3, 700 W, device time of a CUDA-graph
// replay, tools/kernel_times.py; PERF.md section 6): 2 x 512 keypoints
// x 805 samples nearest 0.027 ms, the dense matcher's 2 x 1024 bilinear
// 0.090 ms; in the same call the first design took 0.030 and 0.157 ms;
// 2r+1 lanes per box took 0.049 and 0.214 ms, the bank-interleaved order
// 0.035 ms nearest. No integral image: an f32 integral of raw
// [0, 255] pixels would reach ~1.25e6, whose ulp (0.125) breaks the
// sampler's tolerance; direct sums have no such error.
//
// Stage ablation (replaces benchmarks/ablate_sampler.py, _kernel /
// _ablated_sample, the stage-skipping copy of the TPU kernel): the kernel
// is a template on a mask of stages to skip, so the timed variants and the
// production kernel (mask 0, oip_sparse_sampler) are one function. Skipping
// gives wrong outputs on purpose; the time a variant saves is the cost of
// its stage:
//   SKIP_LOAD    the window is filled from its element index, with no reads
//                of the image (the TPU harness's roll and its DMA);
//   SKIP_BOXSUM  each box is read at its centre cell once instead of summed
//                (masks + matmul);
//   SKIP_STORE   a sample is stored only if it equals a sentinel the host
//                passes as NaN, so the work stays and no store happens
//                (epilogue).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SKIP_LOAD = 1, SKIP_BOXSUM = 2, SKIP_STORE = 4;
constexpr int kWarps = 8;  // warps per CTA; the wrapper's plan is built for it

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Sum of the w cells row[0..w-1], left to right.
__device__ __forceinline__ float row_sum(const float* row, int w) {
  float acc = row[0];
  for (int dx = 1; dx < w; ++dx) acc += row[dx];
  return acc;
}

__device__ __forceinline__ float mean(float total, int r) {
  return r > 0 ? total / (float)((2 * r + 1) * (2 * r + 1)) : total;
}

// (1 - w) a + w b, each product and the sum rounded on its own, as the
// twin's separate tensor operations are.
__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(1.f - w, a), __fmul_rn(w, b));
}

// Mean of the w x w box whose top-left cell is box[0]: rows summed left to
// right, then added top to bottom.
__device__ __forceinline__ float box_mean(const float* box, int psi, int r) {
  const int w = 2 * r + 1;
  float total = row_sum(box, w);
  for (int dy = 1; dy < w; ++dy) total += row_sum(box + dy * psi, w);
  return mean(total, r);
}

template <int SKIP>
__global__ void __launch_bounds__(kWarps * 32)
sparse_sampler_kernel(const float* __restrict__ image, const int* __restrict__ start_y,
                      const int* __restrict__ start_x, const float* __restrict__ ly,
                      const float* __restrict__ lx, const int* __restrict__ plan,
                      float* __restrict__ out, int k, int s, int hp, int wp, int ps,
                      int r_max, int bilinear, float sentinel) {
  extern __shared__ float win[];
  const int psi = ps + 2 * r_max;
  const int kp = blockIdx.x;  // flat keypoint index b * k + i
  const int b = kp / k;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // The window, by rows: a warp per row, lanes along x. Clamp the origin so
  // the window fits, as jax.lax.dynamic_slice does.
  const int y0 = min(max(start_y[kp], 0), hp - psi);
  const int x0 = min(max(start_x[kp], 0), wp - psi);
  const float* img = image + ((size_t)b * hp + y0) * wp + x0;
  for (int row = warp; row < psi; row += kWarps) {
    for (int c = lane; c < psi; c += 32) {
      if constexpr ((SKIP & SKIP_LOAD) != 0) {
        win[row * psi + c] = (float)((row * psi + c) & 255);
      } else {
        win[row * psi + c] = img[(size_t)row * wp + c];
      }
    }
  }
  __syncthreads();

  const float* lyk = ly + (size_t)kp * s;
  const float* lxk = lx + (size_t)kp * s;
  float* outk = out + (size_t)kp * s;
  const float last = (float)(ps - 1);
  const int* tasks = plan + kWarps + 1;
  for (int t = plan[warp]; t < plan[warp + 1]; ++t) {
    // A task: samples lo .. lo + n - 1 (n <= 32) of radius r, one a lane.
    const int r = tasks[3 * t], lo = tasks[3 * t + 1], n = tasks[3 * t + 2];
    if (lane >= n) continue;
    const int j = lo + lane;
    const int w = 2 * r + 1;
    const float* base = win + (r_max - r) * (psi + 1);  // radius-r boxes start r_max - r into the halo
    const float y = lyk[j], x = lxk[j];
    float v;
    if (!bilinear) {
      const int iy = (int)rintf(clampf(y, 0.f, last));
      const int ix = (int)rintf(clampf(x, 0.f, last));
      if constexpr ((SKIP & SKIP_BOXSUM) != 0) {
        v = base[(iy + r) * psi + ix + r];
      } else {
        v = box_mean(base + iy * psi + ix, psi, r);
      }
    } else {
      const float fy = floorf(y), fx = floorf(x);
      const float wy = y - fy, wx = x - fx;
      const int y_lo = (int)clampf(fy, 0.f, last);
      const int y_hi = (int)clampf(fy + 1.f, 0.f, last);
      const int x_lo = (int)clampf(fx, 0.f, last);
      const int x_hi = (int)clampf(fx + 1.f, 0.f, last);
      float t_ll, t_hl, t_lh, t_hh;
      if constexpr ((SKIP & SKIP_BOXSUM) != 0) {
        const float* c = base + r * (psi + 1);
        t_ll = c[y_lo * psi + x_lo];
        t_hl = c[y_hi * psi + x_lo];
        t_lh = c[y_lo * psi + x_hi];
        t_hh = c[y_hi * psi + x_hi];
      } else {
        // The boxes at y_lo and y_hi = y_lo + 1 share all but one row: each
        // of the rows y_lo .. y_hi + 2r is summed once at x_lo and once at
        // x_hi and added, in row order, into the taps whose box holds it.
        const int dy_hi = y_hi - y_lo;
        const float* row = base + y_lo * psi;
        t_ll = t_lh = t_hl = t_hh = 0.f;
        for (int d = 0; d < w + dy_hi; ++d, row += psi) {
          const float a = row_sum(row + x_lo, w), h = row_sum(row + x_hi, w);
          if (d < w) {
            t_ll = d == 0 ? a : t_ll + a;
            t_lh = d == 0 ? h : t_lh + h;
          }
          if (d >= dy_hi) {
            t_hl = d == dy_hi ? a : t_hl + a;
            t_hh = d == dy_hi ? h : t_hh + h;
          }
        }
        t_ll = mean(t_ll, r);
        t_hl = mean(t_hl, r);
        t_lh = mean(t_lh, r);
        t_hh = mean(t_hh, r);
      }
      v = lerp_rn(lerp_rn(t_ll, t_hl, wy), lerp_rn(t_lh, t_hh, wy), wx);
    }
    if constexpr ((SKIP & SKIP_STORE) != 0) {
      if (v == sentinel) outk[j] = v;
    } else {
      outk[j] = v;
    }
  }
}

template <int SKIP>
int launch(const float* image, const int* start_y, const int* start_x,
           const float* ly, const float* lx, const int* plan, float* out,
           int b, int k, int s, int hp, int wp, int ps, int r_max, int bilinear,
           float sentinel, cudaStream_t stream) {
  const int psi = ps + 2 * r_max;
  const size_t smem = sizeof(float) * (size_t)psi * psi;
  sparse_sampler_kernel<SKIP><<<b * k, kWarps * 32, smem, stream>>>(
      image, start_y, start_x, ly, lx, plan, out, k, s, hp, wp, ps, r_max,
      bilinear, sentinel);
  return (int)cudaGetLastError();
}

}  // namespace

// image (b, hp, wp) f32 replicate-padded by r_max; start_y, start_x (b*k)
// i32 window origins in padded coordinates; ly, lx (b*k, s) f32 in-window
// sample coordinates in [0, ps - 1]; plan: the wrapper's sampler_plan (i32,
// dealt to kWarps warps) -> out (b*k, s) f32. Returns cudaGetLastError()
// after the launch.
extern "C" int oip_sparse_sampler(const float* image, const int* start_y,
                                  const int* start_x, const float* ly,
                                  const float* lx, const int* plan, float* out,
                                  int b, int k, int s, int hp, int wp, int ps,
                                  int r_max, int bilinear, void* stream) {
  return launch<0>(image, start_y, start_x, ly, lx, plan, out, b, k, s, hp,
                   wp, ps, r_max, bilinear, 0.f, (cudaStream_t)stream);
}

// The same with the stages in ``skip`` (a mask of SKIP_LOAD = 1,
// SKIP_BOXSUM = 2, SKIP_STORE = 4) left out; ``sentinel`` is the value a
// sample must equal to be stored under SKIP_STORE (the host passes NaN).
// Returns cudaErrorInvalidValue for a mask outside 0..7.
extern "C" int oip_sparse_sampler_ablate(const float* image, const int* start_y,
                                         const int* start_x, const float* ly,
                                         const float* lx, const int* plan,
                                         float* out, int b, int k, int s, int hp,
                                         int wp, int ps, int r_max, int bilinear,
                                         int skip, float sentinel, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define OIP_ABLATE(M)                                                          \
  case M:                                                                      \
    return launch<M>(image, start_y, start_x, ly, lx, plan, out, b, k, s, hp,  \
                     wp, ps, r_max, bilinear, sentinel, st);
  switch (skip) {
    OIP_ABLATE(0) OIP_ABLATE(1) OIP_ABLATE(2) OIP_ABLATE(3)
    OIP_ABLATE(4) OIP_ABLATE(5) OIP_ABLATE(6) OIP_ABLATE(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OIP_ABLATE
}
