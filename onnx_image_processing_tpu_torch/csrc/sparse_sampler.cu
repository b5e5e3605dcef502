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
// output), so it is bound by shared-memory load throughput, not by HBM.
// Design: one CTA per keypoint loads its 70 x 70 window (19.6 KB) into
// shared memory once; its threads split the S samples and sum each box
// directly from shared memory (at most 225 loads). No integral image: an
// f32 integral of raw [0, 255] pixels would reach ~1.25e6, whose ulp (0.125)
// breaks the sampler's tolerance; direct sums have no such error.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

__global__ void sparse_sampler_kernel(const float* __restrict__ image,
                                      const int* __restrict__ start_y,
                                      const int* __restrict__ start_x,
                                      const float* __restrict__ ly,
                                      const float* __restrict__ lx,
                                      const int* __restrict__ radius,
                                      float* __restrict__ out, int k, int s,
                                      int hp, int wp, int ps, int r_max,
                                      int bilinear) {
  extern __shared__ float win[];
  const int psi = ps + 2 * r_max;
  const int kp = blockIdx.x;  // flat keypoint index b * k + i
  const int b = kp / k;
  // Clamp the origin so the window fits, as jax.lax.dynamic_slice does.
  const int y0 = min(max(start_y[kp], 0), hp - psi);
  const int x0 = min(max(start_x[kp], 0), wp - psi);
  const float* img = image + (size_t)b * hp * wp;
  for (int i = threadIdx.x; i < psi * psi; i += blockDim.x)
    win[i] = img[(size_t)(y0 + i / psi) * wp + x0 + i % psi];
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
      v = box_mean(win, psi, o + iy, o + ix, r);
    } else {
      const float fy = floorf(y), fx = floorf(x);
      const float wy = y - fy, wx = x - fx;
      const int y_lo = (int)clampf(fy, 0.f, last);
      const int y_hi = (int)clampf(fy + 1.f, 0.f, last);
      const int x_lo = (int)clampf(fx, 0.f, last);
      const int x_hi = (int)clampf(fx + 1.f, 0.f, last);
      const float col_lo = (1.f - wy) * box_mean(win, psi, o + y_lo, o + x_lo, r) +
                           wy * box_mean(win, psi, o + y_hi, o + x_lo, r);
      const float col_hi = (1.f - wy) * box_mean(win, psi, o + y_lo, o + x_hi, r) +
                           wy * box_mean(win, psi, o + y_hi, o + x_hi, r);
      v = (1.f - wx) * col_lo + wx * col_hi;
    }
    outk[j] = v;
  }
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
  const int psi = ps + 2 * r_max;
  const size_t smem = sizeof(float) * (size_t)psi * psi;
  sparse_sampler_kernel<<<b * k, 256, smem, (cudaStream_t)stream>>>(
      image, start_y, start_x, ly, lx, radius, out, k, s, hp, wp, ps, r_max,
      bilinear);
  return (int)cudaGetLastError();
}
