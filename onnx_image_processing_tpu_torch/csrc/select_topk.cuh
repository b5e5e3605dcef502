// The block top-k and its decode, run by the last CTA of an image: shared by
// select_frontend.cu (the select kernel's fused top-k) and
// detect_frontend.cu (detect_select). Each kernel first writes the image's
// block maxima and their minimum raster indices, takes a ticket on the
// image's counter, and the CTA that completes the count calls select_phase.
//
// Only positive maxima reach the output, and a positive float orders like
// its bits, so each candidate is one 64-bit key (value bits, then the
// complement of its block index): distinct keys whose descending order is
// the stable sort's. The CTA copies the image's block maxima into its
// shared memory (up to kStageMax of them; past that it reads them from L2),
// a radix select on 11-bit digits finds the K-th key (one histogram pass per
// digit, stopping as soon as the K-th key's digit bin is taken whole), and
// the survivors are compacted (a scan of per-thread counts), bitonic-sorted
// in shared memory (in a global scratch past kSmemKeys; the stages within a
// warp's 32 keys by shuffles) and decoded: slots whose score is <= 0 become (-1, -1) with
// score 0.
//
// Every function is templated on the CTA's thread count THREADS (a multiple
// of 32, at most 1024, dividing kBins).

#pragma once

#include <cuda_runtime.h>

namespace oip_topk {

constexpr int kSmemKeys = 4096;    // survivors sorted in shared memory up to this many
constexpr int kStageMax = 32768;   // block maxima copied to shared memory up to this many
constexpr int kDigitBits = 11;     // radix digit: 2048 bins
constexpr int kBins = 1 << kDigitBits;

// Histogram, warp sums and four ints, rounded to 8 bytes for the keys after.
template <int THREADS>
__host__ __device__ constexpr size_t head_bytes() {
  return (sizeof(unsigned) * kBins + sizeof(int) * (THREADS / 32 + 4) + 7) / 8 * 8;
}

// Dynamic shared memory of the select phase, in bytes: kBins histogram bins,
// the warps' sums and four ints; then, when they fit, the survivors' 64-bit
// keys (a power of two >= k, up to kSmemKeys) and a copy of the image's n
// block maxima (up to kStageMax). What does not fit stays in device memory.
template <int THREADS>
__host__ __device__ inline size_t select_smem(int n, int k, bool* keys_in_smem, bool* staged) {
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  *keys_in_smem = p2 <= kSmemKeys;
  *staged = n <= kStageMax;
  return head_bytes<THREADS>() + (*keys_in_smem ? sizeof(unsigned long long) * p2 : 0) +
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
template <int THREADS>
__device__ int cta_exclusive_scan(int v, int* warp_sums, int* total) {
  constexpr int kWarps = THREADS / 32;
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
// global writes after __syncthreads). Compare-exchanges whose partners are
// 32 or more keys apart go through memory, one barrier each; the rest of
// each merge (partners within one warp's 32 keys) runs in registers with
// shuffles, one barrier per merge.
__device__ inline void bitonic_desc(unsigned long long* keys, int n) {
  const int lane = threadIdx.x % 32;
  for (int k = 2; k <= n; k <<= 1) {
    int j = k >> 1;
    for (; j > 0 && (j >= 32 || n < 32); j >>= 1) {
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
    if (j == 0) continue;
    // n >= 32: whole warps hold 32 consecutive keys each.
    for (int i0 = threadIdx.x - lane; i0 < n; i0 += blockDim.x) {
      const int i = i0 + lane;
      const bool desc = (i & k) == 0;
      unsigned long long v = keys[i];
      for (int jj = j; jj > 0; jj >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, jj);
        const bool keep_max = ((i & jj) == 0) == desc;
        v = keep_max ? (v > o ? v : o) : (v < o ? v : o);
      }
      keys[i] = v;
    }
    __syncthreads();
  }
}

// The last CTA of an image: the top k of its n block maxima (vals_global,
// with their raster indices idx), decoded to kpts (k, 2) (y, x) and kscores
// (k); w is the image width. smem holds at least select_smem<THREADS>(n, k).
template <int THREADS>
__device__ void select_phase(const float* vals_global, const int* idx,
                             unsigned long long* keys_global, float* kpts, float* kscores, int n,
                             int k, int w, float* smem) {
  constexpr int kWarps = THREADS / 32;
  bool keys_in_smem, staged;
  select_smem<THREADS>(n, k, &keys_in_smem, &staged);
  unsigned* hist = (unsigned*)smem;                     // kBins bins
  int* warp_sums = (int*)(hist + kBins);                // kWarps
  int* shared_int = warp_sums + kWarps;                 // 4 ints
  char* tail = (char*)smem + head_bytes<THREADS>();
  int p2k = 1;
  while (p2k < k) p2k <<= 1;
  unsigned long long* keys = keys_in_smem ? (unsigned long long*)tail : keys_global;
  float* vals_smem = (float*)(tail + (keys_in_smem ? sizeof(unsigned long long) * p2k : 0));
  const int tid = threadIdx.x;

  // The block maxima into shared memory, 8 independent loads in flight per
  // thread; and the count of candidates (positive maxima).
  const float* vals = staged ? vals_smem : vals_global;
  int pos = 0;
  constexpr int kBatch = 8;
  for (int base = 0; base < n; base += kBatch * THREADS) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * THREADS + tid;
      v[j] = i < n ? __ldcg(vals_global + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * THREADS + tid;
      if (i < n) {
        if (staged) vals_smem[i] = v[j];
        pos += v[j] > 0.f;
      }
    }
  }
  int npos;
  cta_exclusive_scan<THREADS>(pos, warp_sums, &npos);   // also orders the staging stores

  // With at most k candidates every one survives; else a radix select on
  // kDigitBits-bit digits, from the top, finds the k-th key.
  unsigned long long thresh = 1ull;   // survivors: key >= thresh (0 is no candidate)
  if (npos > k) {
    unsigned long long prefix = 0ull, mask = 0ull;
    int want = k;   // keys still to take among those matching prefix
    const int rounds = (n + THREADS - 1) / THREADS;
    for (int shift = 64; shift > 0;) {
      const int nb = shift < kDigitBits ? shift : kDigitBits;
      shift -= nb;
      const unsigned dmask = (1u << nb) - 1u;
      for (int i = tid; i < kBins; i += THREADS) hist[i] = 0u;
      __syncthreads();
      for (int round = 0; round < rounds; ++round) {
        const int i = round * THREADS + tid;
        const unsigned long long key = i < n ? block_key(block_val(vals, staged, i), i) : 0ull;
        const bool live = key != 0ull && (key & mask) == prefix;
        // Few keys are live (the positive maxima, then those that match the
        // prefix), so a plain atomic each is cheapest.
        if (live) atomicAdd(hist + ((unsigned)(key >> shift) & dmask), 1u);
      }
      __syncthreads();
      // The bins from the top: thread t holds bins kBins-1-kPer*t down to
      // kBins-kPer*(t+1); the one whose counts straddle `want` names the
      // k-th key's digit.
      constexpr int kPer = kBins / THREADS;
      unsigned cnt[kPer], local = 0u;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        cnt[j] = hist[kBins - 1 - kPer * tid - j];
        local += cnt[j];
      }
      int total;
      unsigned before = (unsigned)cta_exclusive_scan<THREADS>((int)local, warp_sums, &total);
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

  // Compact the survivors (min(npos, k) of them) in block order: each
  // thread counts its survivors, a scan gives its first slot, and it writes
  // them there. Then sort them.
  const int survivors = min(npos, k);
  int p2 = 1;
  while (p2 < survivors) p2 <<= 1;
  int mine = 0;
  for (int i = tid; i < n; i += THREADS) {
    const unsigned long long key = block_key(block_val(vals, staged, i), i);
    mine += key != 0ull && key >= thresh;
  }
  int total;
  int slot = cta_exclusive_scan<THREADS>(mine, warp_sums, &total);
  for (int i = tid; i < n && mine > 0; i += THREADS) {
    const unsigned long long key = block_key(block_val(vals, staged, i), i);
    if (key != 0ull && key >= thresh) {
      keys[slot++] = key;
      --mine;
    }
  }
  for (int i = survivors + tid; i < p2; i += THREADS) keys[i] = 0ull;
  __syncthreads();
  bitonic_desc(keys, p2);

  // Decode: y = idx // w, x = idx % w of the block's raster index.
  for (int s = tid; s < k; s += THREADS) {
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

// The ticket after a CTA's block writes: every thread must call it. One
// fence (as a grid barrier releases a CTA's writes), then thread 0 counts
// the CTA in on counters[b]; true in the CTA that completes the image's
// count of per_image CTAs, which must then select and set counters[b]
// back to 0 (so no memset precedes a launch and a CUDA-graph replay starts
// from 0 again).
__device__ inline bool last_of_image(unsigned* counters, int b, unsigned per_image) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counters + b, 1u) == per_image - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

}  // namespace oip_topk
