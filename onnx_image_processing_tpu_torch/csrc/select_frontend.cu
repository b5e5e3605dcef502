// Fused NMS + masking + block-reduced keypoint candidates, for Hopper (sm_90a).
//
// Replaces: onnx_image_processing_tpu/kernels/select_frontend.py,
//   nms_block_reduce_padded -> _nms_block_reduce_impl -> _select_kernel
//   (the Pallas TPU kernel). Plain twin: nms_block_reduce_plain in
//   onnx_image_processing_tpu_torch/kernels/select_frontend.py, the port of
//   ops/keypoints.py _block_reduce_xla plus the NMS/border/threshold masks.
//
// Computes, per image: the (2r+1)^2 local max with a -inf border, the keep
// mask `score >= local_max - 1e-7f`, the border-margin and threshold masks,
// and for every (r+1)x(r+1) block its max and the minimum raster index
// y*W + x among the cells equal to that max. Every output is a max, a
// compare or a copy, so the kernel is bit-identical to its twin: the slack
// is the float literal 1e-7f (a bare 1e-7 would move the compare to double)
// and masking multiplies by exactly 1.f or 0.f as the twin does.
//
// What bounds it on this card: at 2 x 480 x 640 the work is ~20 max/compare
// operations per pixel over a 2.4 MB map, so it is bound by the map's trip
// through device memory (about 1 us at 3.35 TB/s) and by launch latency.
// Design: one pass. A CTA owns a tile of whole output blocks (about 32 x 32
// pixels), loads the tile plus an r-pixel halo into shared memory once, takes
// the window max separably (rows, then columns) in shared memory, masks, and
// reduces each block there. Halo re-reads cost ~1.8x the map's bytes, all of
// it served from L2.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void select_frontend_kernel(const float* __restrict__ scores,
                                       float* __restrict__ out_max,
                                       int* __restrict__ out_idx,
                                       int h, int w, int r, int margin,
                                       float thr, int hb, int wb, int tb) {
  extern __shared__ float smem[];
  const int bs = r + 1;
  const int tile = tb * bs;               // pixels per tile side
  const int halo = tile + 2 * r;          // tile plus the NMS window halo
  float* win = smem;                      // halo x halo scores, -inf outside
  float* rowmax = win + halo * halo;      // halo x tile horizontal maxima
  float* masked = rowmax + halo * tile;   // tile x tile masked scores

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * tb, ox0 = blockIdx.x * tb;  // first block
  const int y0 = oy0 * bs, x0 = ox0 * bs;                  // first pixel
  const float* img = scores + (size_t)b * h * w;

  for (int i = threadIdx.x; i < halo * halo; i += blockDim.x) {
    const int gy = y0 - r + i / halo, gx = x0 - r + i % halo;
    win[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                 ? img[(size_t)gy * w + gx] : -INFINITY;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < halo * tile; i += blockDim.x) {
    const float* row = win + (i / tile) * halo + i % tile;
    float m = row[0];
    for (int d = 1; d <= 2 * r; ++d) m = fmaxf(m, row[d]);
    rowmax[i] = m;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tile * tile; i += blockDim.x) {
    const int py = i / tile, px = i % tile;
    const int gy = y0 + py, gx = x0 + px;
    float m = 0.f;  // cells past the map's edge pad the last blocks with 0
    if (gy < h && gx < w) {
      float lm = rowmax[py * tile + px];
      for (int d = 1; d <= 2 * r; ++d) lm = fmaxf(lm, rowmax[(py + d) * tile + px]);
      const float c = win[(py + r) * halo + px + r];
      m = c * (c >= lm - 1e-7f ? 1.f : 0.f);
      if (margin > 0) {
        const bool inside = gy >= margin && gy < h - margin &&
                            gx >= margin && gx < w - margin;
        m = m * (inside ? 1.f : 0.f);
      }
      m = m > thr ? m : 0.f;
    }
    masked[i] = m;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tb * tb; i += blockDim.x) {
    const int oy = oy0 + i / tb, ox = ox0 + i % tb;
    if (oy >= hb || ox >= wb) continue;
    const float* cell = masked + (i / tb) * bs * tile + (i % tb) * bs;
    float best = -INFINITY;
    for (int dy = 0; dy < bs; ++dy)
      for (int dx = 0; dx < bs; ++dx) best = fmaxf(best, cell[dy * tile + dx]);
    // Minimum index, not first in raster order: a block that overhangs the
    // right edge gives its pad cells indices past the row's end.
    int idx = INT_MAX;
    for (int dy = 0; dy < bs; ++dy)
      for (int dx = 0; dx < bs; ++dx)
        if (cell[dy * tile + dx] == best)
          idx = min(idx, (oy * bs + dy) * w + ox * bs + dx);
    const size_t o = ((size_t)b * hb + oy) * wb + ox;
    out_max[o] = best;
    out_idx[o] = idx;
  }
}

}  // namespace

// scores (b, h, w) f32 -> out_max, out_idx (b, hb, wb) with hb = ceil(h/(r+1)),
// wb = ceil(w/(r+1)). Returns cudaGetLastError() after the launch.
extern "C" int oip_select_frontend(const float* scores, float* out_max,
                                   int* out_idx, int b, int h, int w, int r,
                                   int margin, float thr, void* stream) {
  const int bs = r + 1;
  const int hb = (h + bs - 1) / bs, wb = (w + bs - 1) / bs;
  const int tb = bs >= 32 ? 1 : 32 / bs;  // output blocks per tile side
  const int tile = tb * bs, halo = tile + 2 * r;
  const size_t smem = sizeof(float) * ((size_t)halo * halo + (size_t)halo * tile +
                                       (size_t)tile * tile);
  const dim3 grid((wb + tb - 1) / tb, (hb + tb - 1) / tb, b);
  select_frontend_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      scores, out_max, out_idx, h, w, r, margin, thr, hb, wb, tb);
  return (int)cudaGetLastError();
}
