// Fused NMS + masking + block-reduced keypoint candidates, and the block
// top-k with its decode, for Hopper (sm_90a).
//
// Replaces: onnx_image_processing_tpu/kernels/select_frontend.py,
//   nms_block_reduce_padded -> _nms_block_reduce_impl -> _select_kernel
//   (the Pallas TPU kernel), and the top-k and decode that follow it in
//   ops/keypoints.py nms_select_topk. Plain twins: nms_block_reduce_plain
//   and nms_select_blocks_plain in
//   onnx_image_processing_tpu_torch/kernels/select_frontend.py.
//
// Computes, per image: the (2r+1)^2 local max with a -inf border, the keep
// mask `score >= local_max - 1e-7f`, the border-margin and threshold masks,
// and for every (r+1)x(r+1) block its max and the minimum raster index
// y*W + x among the cells equal to that max. Every output is a max, a
// compare or a copy, so the kernel is bit-identical to its twin: the slack
// is the float literal 1e-7f (a bare 1e-7 would move the compare to double)
// and masking multiplies by exactly 1.f or 0.f as the twin does.
// oip_select_topk then keeps the K largest block maxima, in the order of a
// stable descending sort over the row-major block grid, and decodes them to
// (y, x) keypoints; slots whose score is <= 0 become (-1, -1) with score 0.
//
// What bounds it on this card: at 2 x 480 x 640 the work is ~20 max/compare
// operations per pixel over a 2.4 MB map, so it is bound by the map's trip
// through device memory (about 1 us at 3.35 TB/s) and by launch latency.
// Design: one pass. A CTA owns a tile of whole output blocks (about 32 x 32
// pixels), loads the tile plus an r-pixel halo into shared memory once, takes
// the window max separably (rows, then columns) in shared memory, masks, and
// reduces each block there. Halo re-reads cost ~1.8x the map's bytes, all of
// it served from L2.
// The top-k in the same launch: each CTA takes a ticket on its image's
// counter when its blocks are written, and the image's last CTA selects:
// radix select, sort and decode, in select_topk.cuh (shared with
// detect_frontend.cu's detect_select). The last CTA sets the counter back to
// 0, so no memset precedes a launch and a CUDA-graph replay starts from 0
// again.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "select_topk.cuh"

namespace {

using namespace oip_topk;

constexpr int kBlockThreads = 256;   // the block-reduce kernel alone
constexpr int kThreads = 1024;       // the top-k kernel: its last CTA selects
constexpr int kMaxDevices = 64;

// The block phase: CTA (blockIdx.x, blockIdx.y) of image blockIdx.z writes
// the max and minimum raster index of its tb x tb output blocks.
__device__ void block_phase(const float* __restrict__ scores, float* out_max, int* out_idx,
                            float* smem, int h, int w, int r, int margin, float thr, int hb,
                            int wb, int tb) {
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

__global__ void __launch_bounds__(kBlockThreads)
select_frontend_kernel(const float* __restrict__ scores, float* __restrict__ out_max,
                       int* __restrict__ out_idx, int h, int w, int r, int margin, float thr,
                       int hb, int wb, int tb) {
  extern __shared__ float smem[];
  block_phase(scores, out_max, out_idx, smem, h, w, r, margin, thr, hb, wb, tb);
}

__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const float* __restrict__ scores, float* block_max, int* block_idx,
                   unsigned* counters, unsigned long long* keys_global, float* kpts,
                   float* kscores, int h, int w, int r, int margin, float thr, int hb, int wb,
                   int tb, int k, int keys_stride) {
  extern __shared__ float smem[];
  block_phase(scores, block_max, block_idx, smem, h, w, r, margin, thr, hb, wb, tb);
  // Ticket: the CTA that completes its image's count selects.
  const int b = blockIdx.z;
  if (!last_of_image(counters, b, gridDim.x * gridDim.y)) return;
  const int n = hb * wb;
  select_phase<kThreads>(block_max + (size_t)b * n, block_idx + (size_t)b * n,
                         keys_global + (size_t)b * keys_stride, kpts + (size_t)b * k * 2,
                         kscores + (size_t)b * k, n, k, w, smem);
  if (threadIdx.x == 0) counters[b] = 0u;   // ready for the next launch
}

struct Layout {
  int hb, wb, tb;
  size_t smem;
  dim3 grid;
};

// The block phase's grid: tiles of about `side` pixels (whole blocks).
Layout layout(int b, int h, int w, int r, int side) {
  Layout l;
  const int bs = r + 1;
  l.hb = (h + bs - 1) / bs;
  l.wb = (w + bs - 1) / bs;
  l.tb = bs >= side ? 1 : side / bs;  // output blocks per tile side
  const size_t tile = (size_t)l.tb * bs, halo = tile + 2 * r;
  l.smem = sizeof(float) * (halo * halo + halo * tile + tile * tile);
  l.grid = dim3((l.wb + l.tb - 1) / l.tb, (l.hb + l.tb - 1) / l.tb, b);
  return l;
}

// Raises the top-k kernel's dynamic shared memory limit on the current
// device to at least smem (an attribute is set per device; each is set once).
cudaError_t set_smem(size_t smem) {
  static size_t smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (smem <= 48 * 1024 || (device < kMaxDevices && smem <= smem_set[device])) return cudaSuccess;
  err = cudaFuncSetAttribute(select_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && device < kMaxDevices) smem_set[device] = smem;
  return err;
}

}  // namespace

// scores (b, h, w) f32 -> out_max, out_idx (b, hb, wb) with hb = ceil(h/(r+1)),
// wb = ceil(w/(r+1)). Returns cudaGetLastError() after the launch.
extern "C" int oip_select_frontend(const float* scores, float* out_max,
                                   int* out_idx, int b, int h, int w, int r,
                                   int margin, float thr, void* stream) {
  const Layout l = layout(b, h, w, r, 32);
  select_frontend_kernel<<<l.grid, kBlockThreads, l.smem, (cudaStream_t)stream>>>(
      scores, out_max, out_idx, h, w, r, margin, thr, l.hb, l.wb, l.tb);
  return (int)cudaGetLastError();
}

// scores (b, h, w) f32 -> kpts (b, k, 2) f32 (y, x) and kscores (b, k): the
// k largest block maxima of each image in one launch. block_max, block_idx
// (b, hb, wb) are scratch; counters (b) must be 0 before the first launch
// and are 0 again after each; keys_global holds keys_stride 64-bit keys per
// image (a power of two >= k) when k exceeds the shared-memory sort, else it
// is unused. Requires 1 <= k <= hb * wb.
extern "C" int oip_select_topk(const float* scores, float* block_max, int* block_idx,
                               unsigned* counters, unsigned long long* keys_global, float* kpts,
                               float* kscores, int b, int h, int w, int r, int margin,
                               float thr, int k, int keys_stride, void* stream) {
  // 1024 threads a CTA: tiles of 64 pixels give each thread the 4 pixels
  // that 256 threads have on the 32-pixel tiles of oip_select_frontend.
  const Layout l = layout(b, h, w, r, 64);
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  if (k < 1 || k > l.hb * l.wb || (p2 > kSmemKeys && (keys_global == nullptr ||
                                                      keys_stride < p2)))
    return (int)cudaErrorInvalidValue;
  bool keys_in_smem, staged;
  const size_t sel = select_smem<kThreads>(l.hb * l.wb, k, &keys_in_smem, &staged);
  const size_t smem = l.smem > sel ? l.smem : sel;
  const cudaError_t err = set_smem(smem);
  if (err != cudaSuccess) return (int)err;
  select_topk_kernel<<<l.grid, kThreads, smem, (cudaStream_t)stream>>>(
      scores, block_max, block_idx, counters, keys_global, kpts, kscores, h, w, r, margin, thr,
      l.hb, l.wb, l.tb, k, keys_stride);
  return (int)cudaGetLastError();
}
