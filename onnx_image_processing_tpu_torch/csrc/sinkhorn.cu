// Log-domain Sinkhorn sweeps, for Hopper (sm_90a): one launch per call.
//
// Replaces: onnx_image_processing_tpu/kernels/sinkhorn_kernel.py,
//   sinkhorn_core -> _kernel (the Pallas TPU kernel). Plain twin:
//   sinkhorn_core_plain in
//   onnx_image_processing_tpu_torch/kernels/sinkhorn_kernel.py, the port of
//   the fori_loop body of ops/sinkhorn.py sinkhorn_match.
//
// Computes, for `iters` sweeps on the (n1, m1) log-score matrix S of each
// batch entry:
//   u = log_mu - LSE_row(S + v),  then  v = log_nu - LSE_col(S + u),
// from u = v = 0, then P = exp((S + u) + v). Each LSE is max-subtracted,
// log(sum(exp(x - max))) + max, with a non-finite max replaced by 0 as
// torch.logsumexp does. exp and log are the full-precision expf/logf: the
// port pins P to its twin at 1e-5, which approximate exp/log do not hold.
//
// What bounds it on this card: each sweep is two all-to-all dependencies
// (every u needs all of v, every v all of u) around little work (513 x 513
// f32 is 1.05 MB; a sweep is ~0.5M exps), so what costs is synchronisation
// and the issue rate of the SMs that do the work. The first design launched
// a row-LSE and a column-LSE kernel per sweep, 41 launches per call (~4 us
// each on an H100). The TPU kernel keeps the matrix in VMEM for all sweeps;
// its Hopper counterpart in one thread-block cluster (8 or 16 CTAs holding
// the matrix in shared memory, partials exchanged through distributed
// shared memory) was built and measured 2-4x slower than the 41 launches:
// 16 SMs lack the issue rate for ~40 instructions per entry and sweep, and
// the DSMEM all-gather of partials is bandwidth-bound (PERF.md, Findings).
// Design: one cooperative launch over the whole card. Batch entries run
// side by side, each on its own band of CTAs (grid.y), as many bands as
// keep every line in shared memory with at most 16 lines a CTA (one pass of
// its 16 warps; 4 bands at 513, 2 at 1025), the rest in later rounds: a
// band that reads lines from device memory, or deals its warps a second,
// part-empty pass, was slower than more rounds (PERF.md, Findings). CTA k
// of a band's G (G ~ SMs / bands) owns `lines` rows and `lines` columns of
// S and keeps both in its shared memory: the rows as they are, the columns
// transposed, so that either sweep reads contiguous lines. A sweep is:
// each CTA computes u of its rows from v and publishes it; each CTA that
// owns columns gathers all of u and computes v of its columns; each CTA
// that owns rows gathers all of v. Neither sweep reduces across CTAs, so
// nothing but u and v (a few KB, L2) crosses the card. Each potential is published as one 64-bit word, its
// value and the sweep that wrote it, and a reader spins on the word until
// the tag is its sweep's: the gather is the grid barrier (one real grid
// barrier per launch, to clear the last launch's tags; 40 grid.sync()
// instead cost ~1.1 us each and 12% more time). A word is never rewritten
// before every reader has read it: u(t+1) is written by a CTA that has
// gathered v(t), which every column owner publishes only after it has
// gathered u(t), and no CTA without columns reads u (likewise for v and
// the row owners). A CTA that gathers what it does not need would break
// this chain: when n1 != m1 some CTAs own rows but no columns or the
// reverse, and none of them would publish after its read. A spin that
// outlasts any real wait traps, so a broken chain is an error, not a hang.
// A line is split over a group of warps (16 / lines of them), whose
// partial max and sum meet in shared memory in a fixed order, so the result
// does not change from run to run. Rows or columns that do not fit in
// shared memory (past ~1800 x 1800 at one entry) are read from device
// memory on each sweep: one code path.
// Measured (NVIDIA H100 80GB HBM3, 700 W, device time of a CUDA-graph
// replay, tools/kernel_times.py; PERF.md section 6): 513 x 513 0.104 ms,
// 1025 x 1025 0.170 ms; in the same call the 41 launches took 0.16 and
// 0.30 ms; the cluster design at C = 16 took 0.34 and 0.94 ms. B = 8 in
// one call: 513 0.29 ms (41 launches 0.38), 1025 0.95 ms (41 launches
// 0.82: the 41 launches wait 40 times for all 8 entries, the bands 40
// times in each of 4 rounds).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // opt-in shared memory per CTA
constexpr int kMaxDevices = 64;
// Polls of a potential before the kernel gives up (~seconds; a real wait is
// microseconds, since every CTA of the launch is resident).
constexpr unsigned kMaxPolls = 1u << 24;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The max an LSE subtracts: a non-finite max counts as 0, as in torch.logsumexp.
__device__ __forceinline__ float lse_max(float m) { return isfinite(m) ? m : 0.f; }

// Floats of dynamic shared memory: the resident rows, the resident columns
// (transposed), the vector of the sweep (v or u), the warps' partial max and
// sum, and u of the CTA's rows. The wrapper's sinkhorn_plan computes the same.
__host__ __device__ __forceinline__ size_t smem_floats(int n1, int m1, int lines,
                                                       int res_rows, int res_cols) {
  return (size_t)res_rows * m1 + (size_t)res_cols * n1 + (size_t)max(n1, m1) +
         2 * kWarps + lines;
}

// A potential and the sweep that wrote it, in one 64-bit word, so that a
// reader that sees the sweep's tag also sees its value.
__device__ __forceinline__ void publish(unsigned long long* at, float value, unsigned tag) {
  *(volatile unsigned long long*)at = ((unsigned long long)tag << 32) | __float_as_uint(value);
}

// The n potentials of sweep `tag` into vec, each read (past L1) until the
// CTA that owns it has published it: the grid barrier of the sweep.
__device__ __forceinline__ void gather(float* vec, const unsigned long long* from, int n,
                                       unsigned tag) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    unsigned long long w;
    unsigned polls = 0;
    do {
      w = *(const volatile unsigned long long*)(from + i);
      if (++polls == kMaxPolls) __trap();
    } while ((unsigned)(w >> 32) != tag);
    vec[i] = __uint_as_float((unsigned)w);
  }
  __syncthreads();
}

// One sweep's LSEs over `count` lines of `len` entries, line l starting at
// line_ptr(l) with its entries `stride` apart: marg[l] - LSE(line + vec),
// published to out[l] with `tag` (and kept in own[l] if own is given).
// Lines are dealt to groups of `gw` warps; every thread of the CTA must
// call it (it holds __syncthreads).
template <typename LinePtr>
__device__ void lse_lines(LinePtr line_ptr, int count, int len, const float* vec,
                          const float* __restrict__ marg, unsigned long long* out,
                          unsigned tag, float* own, float* red, int gw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = kWarps / gw;
  const int g = warp / gw, wg = warp % gw;
  const int tg = wg * 32 + lane, span = gw * 32;
  const int rounds = (count + groups - 1) / groups;
  for (int round = 0; round < rounds; ++round) {
    const int l = round * groups + g;
    const bool live = g < groups && l < count;
    const float* line = nullptr;
    int stride = 1;
    if (live) line = line_ptr(l, &stride);
    float m = -INFINITY;
    if (live)
      for (int e = tg; e < len; e += span) m = fmaxf(m, line[(size_t)e * stride] + vec[e]);
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (live) {
      m = red[g * gw];
      for (int k = 1; k < gw; ++k) m = fmaxf(m, red[g * gw + k]);
      m = lse_max(m);
    }
    float s = 0.f;
    if (live)
      for (int e = tg; e < len; e += span) s += expf((line[(size_t)e * stride] + vec[e]) - m);
    s = warp_sum(s);
    if (lane == 0) red[kWarps + warp] = s;
    __syncthreads();
    if (live && tg == 0) {
      s = red[kWarps + g * gw];
      for (int k = 1; k < gw; ++k) s += red[kWarps + g * gw + k];
      const float r = marg[l] - (logf(s) + m);
      publish(out + l, r, tag);
      if (own != nullptr) own[l] = r;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_grid_kernel(const float* __restrict__ ls, const float* __restrict__ log_mu,
                     const float* __restrict__ log_nu, unsigned long long* u,
                     unsigned long long* v, float* __restrict__ p, int batch, int n1, int m1,
                     int iters, int lines, int res_rows, int res_cols) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int k = blockIdx.x, tid = threadIdx.x;
  const int row0 = min(k * lines, n1), col0 = min(k * lines, m1);
  const int rows = min(lines, n1 - row0), cols = min(lines, m1 - col0);
  const int rr = min(res_rows, rows), rc = min(res_cols, cols);
  float* rowslab = smem;                          // rr x m1
  float* colslab = rowslab + (size_t)res_rows * m1;  // rc x n1, transposed
  float* vec = colslab + (size_t)res_cols * n1;   // max(n1, m1)
  float* red = vec + max(n1, m1);                 // 2 x kWarps
  float* own_u = red + 2 * kWarps;                // lines
  // Warps per line: all 16 warps share the CTA's lines.
  const int gw = max(1, kWarps / max(lines, 1));
  // Tags run 1..iters for each entry: clear those of the last launch first.
  const size_t first = ((size_t)blockIdx.y * gridDim.x + k) * kThreads + tid;
  const size_t step = (size_t)gridDim.x * gridDim.y * kThreads;
  for (size_t e = first; e < (size_t)batch * n1; e += step) u[e] = 0ull;
  for (size_t e = first; e < (size_t)batch * m1; e += step) v[e] = 0ull;
  grid.sync();

  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const float* s_b = ls + (size_t)b * n1 * m1;
    const float* srows = s_b + (size_t)row0 * m1;
    unsigned long long* u_b = u + (size_t)b * n1;
    unsigned long long* v_b = v + (size_t)b * m1;
    for (int e = tid; e < rr * m1; e += kThreads) rowslab[e] = srows[e];
    for (int e = tid; e < rc * n1; e += kThreads) {
      const int c = e / n1, i = e - c * n1;
      colslab[e] = s_b[(size_t)i * m1 + col0 + c];
    }
    for (int j = tid; j < m1; j += kThreads) vec[j] = 0.f;
    __syncthreads();

    auto row_ptr = [&](int l, int* stride) -> const float* {
      *stride = 1;
      return l < rr ? rowslab + (size_t)l * m1 : srows + (size_t)l * m1;
    };
    auto col_ptr = [&](int l, int* stride) -> const float* {
      if (l < rc) {
        *stride = 1;
        return colslab + (size_t)l * n1;
      }
      *stride = m1;
      return s_b + col0 + l;
    };
    // Each CTA gathers only what it uses (u if it owns columns, v if it
    // owns rows): see the note on rewriting words at the top.
    for (int it = 0; it < iters; ++it) {
      const unsigned tag = (unsigned)(it + 1);
      lse_lines(row_ptr, rows, m1, vec, log_mu + (size_t)b * n1 + row0, u_b + row0, tag,
                own_u, red, gw);
      if (cols > 0) gather(vec, u_b, n1, tag);
      lse_lines(col_ptr, cols, n1, vec, log_nu + (size_t)b * m1 + col0, v_b + col0, tag,
                nullptr, red, gw);
      if (rows > 0) gather(vec, v_b, m1, tag);
    }

    // P = exp((S + u) + v) on the CTA's rows, in the twin's order of additions.
    float* p_b = p + ((size_t)b * n1 + row0) * m1;
    for (int l = 0; l < rows; ++l) {
      int stride;
      const float* row = row_ptr(l, &stride);
      const float ul = own_u[l];
      for (int j = tid; j < m1; j += kThreads) p_b[(size_t)l * m1 + j] = expf((row[j] + ul) + vec[j]);
    }
    __syncthreads();
  }
}

// The plan's arguments are those of sinkhorn_plan; anything else is refused.
bool plan_ok(int n1, int m1, int ctas, int groups, int lines, int res_rows, int res_cols,
             int smem) {
  return n1 > 0 && m1 > 0 && lines > 0 && ctas > 0 && groups > 0 &&
         (size_t)ctas * lines >= (size_t)max(n1, m1) &&
         res_rows >= 0 && res_rows <= lines && res_cols >= 0 && res_cols <= lines &&
         smem <= kMaxSmem &&
         (size_t)smem == sizeof(float) * smem_floats(n1, m1, lines, res_rows, res_cols);
}

// Raises the kernel's dynamic shared memory limit on the current device to
// at least smem (an attribute is set per device; each is set once).
cudaError_t set_smem(int smem) {
  static int smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && smem <= smem_set[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(sinkhorn_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && device < kMaxDevices) smem_set[device] = smem;
  return err;
}

}  // namespace

// How many CTAs of the plan the current device can hold at once (the
// cooperative launch needs all of them resident), in *resident.
extern "C" int oip_sinkhorn_resident_ctas(int smem, int* resident) {
  cudaError_t err = set_smem(smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinkhorn_grid_kernel, kThreads,
                                                      (size_t)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *resident = per_sm * sms;
  return (int)err;
}

// ls (b, n1, m1), log_mu (b, n1), log_nu (b, m1) f32 -> p (b, n1, m1), in one
// cooperative launch of `groups` bands of `ctas` CTAs laid out by
// sinkhorn_plan (band g takes entries g, g + groups, ...); u (b, n1) and
// v (b, m1) are 64-bit scratch. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a plan that is not sinkhorn_plan's).
extern "C" int oip_sinkhorn(const float* ls, const float* log_mu, const float* log_nu,
                            unsigned long long* u, unsigned long long* v, float* p, int b,
                            int n1, int m1, int iters, int ctas, int groups, int lines,
                            int res_rows, int res_cols, int smem, void* stream) {
  if (b <= 0 || iters <= 0 ||
      !plan_ok(n1, m1, ctas, groups, lines, res_rows, res_cols, smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sinkhorn_grid_kernel, ls, log_mu, log_nu, u, v, p, b, n1, m1,
                           iters, lines, res_rows, res_cols);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
