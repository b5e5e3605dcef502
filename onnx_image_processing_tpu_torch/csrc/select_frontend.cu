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
// counter when its blocks are written, and the image's last CTA selects.
// Only positive maxima reach the output, and a positive float orders like
// its bits, so each candidate is one 64-bit key (value bits, then the
// complement of its block index): distinct keys whose descending order is
// the stable sort's. The last CTA copies the image's block maxima into its
// shared memory (up to kStageMax of them; past that it reads them from L2),
// a radix select on 11-bit digits finds the K-th key (one histogram pass per
// digit, stopping as soon as the K-th key's digit bin is taken whole), and
// the survivors are compacted, bitonic-sorted in shared memory (in a global
// scratch past kSmemKeys) and decoded. The last CTA sets the counter back to 0, so no
// memset precedes a launch and a CUDA-graph replay starts from 0 again.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockThreads = 256;   // the block-reduce kernel alone
constexpr int kThreads = 1024;       // the top-k kernel: its last CTA selects
constexpr int kWarps = kThreads / 32;
constexpr int kSmemKeys = 4096;    // survivors sorted in shared memory up to this many
constexpr int kStageMax = 32768;   // block maxima copied to shared memory up to this many
constexpr int kMaxDevices = 64;
constexpr int kDigitBits = 11;     // radix digit: 2048 bins
constexpr int kBins = 1 << kDigitBits;
// Histogram, warp sums and four ints, rounded to 8 bytes for the keys after.
constexpr size_t kHeadBytes = (sizeof(unsigned) * kBins + sizeof(int) * (kWarps + 4) + 7) / 8 * 8;

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

// Dynamic shared memory of the select phase, in bytes: kBins histogram bins,
// the warps' sums and four ints; then, when they fit, the survivors' 64-bit
// keys (a power of two >= k, up to kSmemKeys) and a copy of the image's n
// block maxima (up to kStageMax). What does not fit stays in device memory.
__host__ __device__ inline size_t select_smem(int n, int k, bool* keys_in_smem, bool* staged) {
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  *keys_in_smem = p2 <= kSmemKeys;
  *staged = n <= kStageMax;
  return kHeadBytes + (*keys_in_smem ? sizeof(unsigned long long) * p2 : 0) +
         (*staged ? sizeof(float) * n : 0);
}

// The selection key of block i with max v: 0 unless v > 0, else the bits of
// v above the complement of i, so that keys are distinct and order as
// (value descending, block index ascending).
__device__ __forceinline__ unsigned long long block_key(float v, int i) {
  if (!(v > 0.f)) return 0ull;
  return ((unsigned long long)__float_as_uint(v) << 32) | (0xffffffffu - (unsigned)i);
}

// Block max i: from the shared copy, or past L1 from device memory (written
// by other CTAs of this launch).
__device__ __forceinline__ float block_val(const float* vals, bool staged, int i) {
  return staged ? vals[i] : __ldcg(vals + i);
}

// Exclusive prefix over the CTA of one int per thread; returns the prefix
// and writes the total to *total. Every thread must call it.
__device__ int cta_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;   // inclusive prefix of the warps
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return before;
}

// Bitonic sort of keys[0, n) (n a power of two) into descending order, by
// the whole CTA; keys lie in shared or global memory (a CTA sees its own
// global writes after __syncthreads).
__device__ void bitonic_desc(unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i], c = keys[p];
          const bool desc = (i & k) == 0;
          if (desc ? a < c : a > c) {
            keys[i] = c;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The last CTA of image b: the top k of its n block maxima, decoded.
__device__ void select_phase(const float* vals_global, const int* idx,
                             unsigned long long* keys_global, float* kpts, float* kscores, int n,
                             int k, int w, float* smem) {
  bool keys_in_smem, staged;
  select_smem(n, k, &keys_in_smem, &staged);
  unsigned* hist = (unsigned*)smem;                     // kBins bins
  int* warp_sums = (int*)(hist + kBins);                // kWarps
  int* shared_int = warp_sums + kWarps;                 // 4 ints
  char* tail = (char*)smem + kHeadBytes;
  int p2k = 1;
  while (p2k < k) p2k <<= 1;
  unsigned long long* keys = keys_in_smem ? (unsigned long long*)tail : keys_global;
  float* vals_smem = (float*)(tail + (keys_in_smem ? sizeof(unsigned long long) * p2k : 0));
  const int tid = threadIdx.x, lane = tid % 32;

  // The block maxima into shared memory, 8 independent loads in flight per
  // thread; and the count of candidates (positive maxima).
  const float* vals = staged ? vals_smem : vals_global;
  int pos = 0;
  constexpr int kBatch = 8;
  for (int base = 0; base < n; base += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads + tid;
      v[j] = i < n ? __ldcg(vals_global + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads + tid;
      if (i < n) {
        if (staged) vals_smem[i] = v[j];
        pos += v[j] > 0.f;
      }
    }
  }
  int npos;
  cta_exclusive_scan(pos, warp_sums, &npos);   // also orders the staging stores

  // With at most k candidates every one survives; else a radix select on
  // kDigitBits-bit digits, from the top, finds the k-th key.
  unsigned long long thresh = 1ull;   // survivors: key >= thresh (0 is no candidate)
  if (npos > k) {
    unsigned long long prefix = 0ull, mask = 0ull;
    int want = k;   // keys still to take among those matching prefix
    const int rounds = (n + kThreads - 1) / kThreads;
    for (int shift = 64; shift > 0;) {
      const int nb = shift < kDigitBits ? shift : kDigitBits;
      shift -= nb;
      const unsigned dmask = (1u << nb) - 1u;
      for (int i = tid; i < kBins; i += kThreads) hist[i] = 0u;
      __syncthreads();
      for (int round = 0; round < rounds; ++round) {
        const int i = round * kThreads + tid;
        const unsigned long long key = i < n ? block_key(block_val(vals, staged, i), i) : 0ull;
        const bool live = key != 0ull && (key & mask) == prefix;
        const unsigned digit = live ? (unsigned)(key >> shift) & dmask : 0u;
        // A warp whose live keys share one digit (the common case in the
        // top digit) adds them in one atomic; else each key adds itself.
        const unsigned lives = __ballot_sync(0xffffffffu, live);
        if (lives == 0u) continue;
        const int leader = __ffs(lives) - 1;
        const unsigned first = __shfl_sync(0xffffffffu, digit, leader);
        if (__all_sync(0xffffffffu, !live || digit == first)) {
          if (lane == leader) atomicAdd(hist + first, (unsigned)__popc(lives));
        } else if (live) {
          atomicAdd(hist + digit, 1u);
        }
      }
      __syncthreads();
      // The bins from the top: thread t holds bins kBins-1-2t and kBins-2-2t;
      // the one whose counts straddle `want` names the k-th key's digit.
      constexpr int kPer = kBins / kThreads;
      unsigned cnt[kPer], local = 0u;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        cnt[j] = hist[kBins - 1 - kPer * tid - j];
        local += cnt[j];
      }
      int total;
      unsigned before = (unsigned)cta_exclusive_scan((int)local, warp_sums, &total);
      if (before < (unsigned)want && (unsigned)want <= before + local) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if ((unsigned)want <= before + cnt[j]) {
            shared_int[0] = kBins - 1 - kPer * tid - j;
            shared_int[1] = want - (int)before;   // to take within the bin
            shared_int[2] = cnt[j] == (unsigned)(want - (int)before);
            break;
          }
          before += cnt[j];
        }
      }
      __syncthreads();
      prefix |= (unsigned long long)shared_int[0] << shift;
      mask |= (unsigned long long)dmask << shift;
      want = shared_int[1];
      const bool whole = shared_int[2] != 0;
      __syncthreads();
      // The k-th key's bin is taken whole: every key >= prefix survives.
      // Keys are distinct, so this holds by the last digit at the latest.
      if (whole) break;
    }
    thresh = prefix;
  }

  // Compact the survivors (min(npos, k) of them), then sort them.
  const int survivors = min(npos, k);
  int p2 = 1;
  while (p2 < survivors) p2 <<= 1;
  if (tid == 0) shared_int[3] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const unsigned long long key = block_key(block_val(vals, staged, i), i);
    if (key != 0ull && key >= thresh) keys[atomicAdd(shared_int + 3, 1)] = key;
  }
  for (int i = survivors + tid; i < p2; i += kThreads) keys[i] = 0ull;
  __syncthreads();
  bitonic_desc(keys, p2);

  // Decode: y = idx // w, x = idx % w of the block's raster index.
  for (int s = tid; s < k; s += kThreads) {
    float y = -1.f, x = -1.f, v = 0.f;
    if (s < survivors) {
      const unsigned long long key = keys[s];
      const int bi = (int)(0xffffffffu - (unsigned)key);
      const int lin = __ldcg(idx + bi);
      v = __uint_as_float((unsigned)(key >> 32));
      y = (float)(lin / w);
      x = (float)(lin % w);
    }
    kpts[2 * (size_t)s] = y;
    kpts[2 * (size_t)s + 1] = x;
    kscores[s] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const float* __restrict__ scores, float* block_max, int* block_idx,
                   unsigned* counters, unsigned long long* keys_global, float* kpts,
                   float* kscores, int h, int w, int r, int margin, float thr, int hb, int wb,
                   int tb, int k, int keys_stride) {
  extern __shared__ float smem[];
  __shared__ int last;
  block_phase(scores, block_max, block_idx, smem, h, w, r, margin, thr, hb, wb, tb);
  // Ticket: after the CTA's block writes, one fence (as a grid barrier
  // releases a CTA's writes) and thread 0 counts the CTA in; the CTA that
  // completes its image's count selects.
  __syncthreads();
  const int b = blockIdx.z;
  const unsigned per_image = gridDim.x * gridDim.y;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counters + b, 1u) == per_image - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n = hb * wb;
  select_phase(block_max + (size_t)b * n, block_idx + (size_t)b * n,
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
  const size_t sel = select_smem(l.hb * l.wb, k, &keys_in_smem, &staged);
  const size_t smem = l.smem > sel ? l.smem : sel;
  const cudaError_t err = set_smem(smem);
  if (err != cudaSuccess) return (int)err;
  select_topk_kernel<<<l.grid, kThreads, smem, (cudaStream_t)stream>>>(
      scores, block_max, block_idx, counters, keys_global, kpts, kscores, h, w, r, margin, thr,
      l.hb, l.wb, l.tb, k, keys_stride);
  return (int)cudaGetLastError();
}
