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
// (2r+1)^2 box, r = radius[j], centred at in-window coordinates
// (ly[j], lx[j]) -- rounded half to even (rintf, as torch.round and
// jnp.round) in nearest mode, two taps per axis in bilinear mode. Each box
// is summed along x, then along y, as the twin's shift-and-add bank is, so
// nearest mode matches the twin to the last bit.
//
// What bounds it on this card: at the flagship shape (2 x 512 keypoints,
// S = 805, radii 1..7) each keypoint needs ~60k shared-memory loads for its
// box sums against ~30 KB of device-memory traffic (window, coordinates,
// output), so it is bound by shared-memory load throughput, not by HBM. On
// an H100 (700 W) the stage ablation below attributes 55% of its device
// time to the box sums and 19% to the window load
// (tools/ablate_sampler.py).
// Design: one CTA per keypoint loads its 70 x 70 window (19.6 KB) into
// shared memory once; its threads split the S samples and sum each box
// directly from shared memory (at most 225 loads). No integral image: an
// f32 integral of raw [0, 255] pixels would reach ~1.25e6, whose ulp (0.125)
// breaks the sampler's tolerance; direct sums have no such error.
//
// Stage ablation (replaces benchmarks/ablate_sampler.py, _kernel /
// _ablated_sample, the stage-skipping copy of the TPU kernel): the kernel
// is a template on a mask of stages to skip, so the timed variants and the
// production kernel (mask 0, oip_sparse_sampler) are one function. Skipping
// gives wrong outputs on purpose; the time a variant saves is the cost of
// its stage:
//   SKIP_LOAD    the window is filled from the thread's loop index, with no
//                reads of the image (the TPU harness's roll and its DMA);
//   SKIP_BOXSUM  each box is read at its centre cell once instead of summed
//                (masks + matmul);
//   SKIP_STORE   a sample is stored only if it equals a sentinel the host
//                passes as NaN, so the work stays and no store happens
//                (epilogue).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SKIP_LOAD = 1, SKIP_BOXSUM = 2, SKIP_STORE = 4;

// Mean of the (2r+1)^2 box whose top-left cell is win[y][x].
__device__ __forceinline__ float box_mean(const float* win, int psi, int y,
                                          int x, int r) {
  float total = 0.f;
  for (int dy = 0; dy <= 2 * r; ++dy) {
    const float* row = win + (y + dy) * psi + x;
    float acc = 0.f;
    for (int dx = 0; dx <= 2 * r; ++dx) acc += row[dx];
    total += acc;
  }
  if (r > 0) total = total / (float)((2 * r + 1) * (2 * r + 1));
  return total;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The box of radius r whose top-left cell is win[y][x]: its mean, or with
// SKIP_BOXSUM its centre cell.
template <int SKIP>
__device__ __forceinline__ float box_value(const float* win, int psi, int y,
                                           int x, int r) {
  if constexpr ((SKIP & SKIP_BOXSUM) != 0) {
    return win[(y + r) * psi + x + r];
  } else {
    return box_mean(win, psi, y, x, r);
  }
}

template <int SKIP>
__global__ void sparse_sampler_kernel(const float* __restrict__ image,
                                      const int* __restrict__ start_y,
                                      const int* __restrict__ start_x,
                                      const float* __restrict__ ly,
                                      const float* __restrict__ lx,
                                      const int* __restrict__ radius,
                                      float* __restrict__ out, int k, int s,
                                      int hp, int wp, int ps, int r_max,
                                      int bilinear, float sentinel) {
  extern __shared__ float win[];
  const int psi = ps + 2 * r_max;
  const int kp = blockIdx.x;  // flat keypoint index b * k + i
  const int b = kp / k;
  // Clamp the origin so the window fits, as jax.lax.dynamic_slice does.
  const int y0 = min(max(start_y[kp], 0), hp - psi);
  const int x0 = min(max(start_x[kp], 0), wp - psi);
  const float* img = image + (size_t)b * hp * wp;
  for (int i = threadIdx.x; i < psi * psi; i += blockDim.x) {
    if constexpr ((SKIP & SKIP_LOAD) != 0) {
      win[i] = (float)(i & 255);
    } else {
      win[i] = img[(size_t)(y0 + i / psi) * wp + x0 + i % psi];
    }
  }
  __syncthreads();

  const float* lyk = ly + (size_t)kp * s;
  const float* lxk = lx + (size_t)kp * s;
  float* outk = out + (size_t)kp * s;
  const float last = (float)(ps - 1);
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    const int r = radius[j];
    const int o = r_max - r;  // radius-r boxes start r_max - r into the halo
    const float y = lyk[j], x = lxk[j];
    float v;
    if (!bilinear) {
      const int iy = (int)rintf(clampf(y, 0.f, last));
      const int ix = (int)rintf(clampf(x, 0.f, last));
      v = box_value<SKIP>(win, psi, o + iy, o + ix, r);
    } else {
      const float fy = floorf(y), fx = floorf(x);
      const float wy = y - fy, wx = x - fx;
      const int y_lo = (int)clampf(fy, 0.f, last);
      const int y_hi = (int)clampf(fy + 1.f, 0.f, last);
      const int x_lo = (int)clampf(fx, 0.f, last);
      const int x_hi = (int)clampf(fx + 1.f, 0.f, last);
      const float col_lo = (1.f - wy) * box_value<SKIP>(win, psi, o + y_lo, o + x_lo, r) +
                           wy * box_value<SKIP>(win, psi, o + y_hi, o + x_lo, r);
      const float col_hi = (1.f - wy) * box_value<SKIP>(win, psi, o + y_lo, o + x_hi, r) +
                           wy * box_value<SKIP>(win, psi, o + y_hi, o + x_hi, r);
      v = (1.f - wx) * col_lo + wx * col_hi;
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
           const float* ly, const float* lx, const int* radius, float* out,
           int b, int k, int s, int hp, int wp, int ps, int r_max, int bilinear,
           float sentinel, cudaStream_t stream) {
  const int psi = ps + 2 * r_max;
  const size_t smem = sizeof(float) * (size_t)psi * psi;
  sparse_sampler_kernel<SKIP><<<b * k, 256, smem, stream>>>(
      image, start_y, start_x, ly, lx, radius, out, k, s, hp, wp, ps, r_max,
      bilinear, sentinel);
  return (int)cudaGetLastError();
}

}  // namespace

// image (b, hp, wp) f32 replicate-padded by r_max; start_y, start_x (b*k)
// i32 window origins in padded coordinates; ly, lx (b*k, s) f32 in-window
// sample coordinates in [0, ps - 1]; radius (s) i32 -> out (b*k, s) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int oip_sparse_sampler(const float* image, const int* start_y,
                                  const int* start_x, const float* ly,
                                  const float* lx, const int* radius,
                                  float* out, int b, int k, int s, int hp,
                                  int wp, int ps, int r_max, int bilinear,
                                  void* stream) {
  return launch<0>(image, start_y, start_x, ly, lx, radius, out, b, k, s, hp,
                   wp, ps, r_max, bilinear, 0.f, (cudaStream_t)stream);
}

// The same with the stages in ``skip`` (a mask of SKIP_LOAD = 1,
// SKIP_BOXSUM = 2, SKIP_STORE = 4) left out; ``sentinel`` is the value a
// sample must equal to be stored under SKIP_STORE (the host passes NaN).
// Returns cudaErrorInvalidValue for a mask outside 0..7.
extern "C" int oip_sparse_sampler_ablate(const float* image, const int* start_y,
                                         const int* start_x, const float* ly,
                                         const float* lx, const int* radius,
                                         float* out, int b, int k, int s,
                                         int hp, int wp, int ps, int r_max,
                                         int bilinear, int skip, float sentinel,
                                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define OIP_ABLATE(M)                                                          \
  case M:                                                                      \
    return launch<M>(image, start_y, start_x, ly, lx, radius, out, b, k, s,    \
                     hp, wp, ps, r_max, bilinear, sentinel, st);
  switch (skip) {
    OIP_ABLATE(0) OIP_ABLATE(1) OIP_ABLATE(2) OIP_ABLATE(3)
    OIP_ABLATE(4) OIP_ABLATE(5) OIP_ABLATE(6) OIP_ABLATE(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OIP_ABLATE
}
