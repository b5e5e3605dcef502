// Log-domain Sinkhorn sweeps, for Hopper (sm_90a).
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
// from u = v = 0, then P = exp(S + u + v). Each LSE is max-subtracted,
// log(sum(exp(x - max))) + max, with a non-finite max replaced by 0 as
// torch.logsumexp does. exp and log are the full-precision expf/logf: the
// port pins P to its twin at 1e-5, which approximate exp/log do not hold.
//
// What bounds it on this card: at K = 512 the matrix is 513 x 513 f32,
// 1.05 MB, above the 227 KB of shared memory one CTA can hold, so the TPU
// kernel's whole-matrix residency does not carry over. Each sweep reads the
// matrix twice (max pass, then sum pass), 2.1 MB, which the 50 MB L2 serves;
// at this size the 41 launches and their latency bound it more than bytes.
// Design: a row-LSE kernel (one CTA per row) and a column-LSE kernel (one
// CTA per 32 columns, 32 row lanes each, reads coalesced along the row)
// launched alternately, the matrix living in L2, then one exp pass. No
// padding, so no sentinel masking is needed.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kColWidth = 32;  // columns per CTA of the column kernel
constexpr int kColLanes = 32;  // row lanes per column

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row sweep: u[i] = log_mu[i] - LSE_j(S[i, j] + v[j]). One CTA per row.
__global__ void row_lse_kernel(const float* __restrict__ ls,
                               const float* __restrict__ log_mu,
                               const float* __restrict__ v,
                               float* __restrict__ u, int n1, int m1) {
  __shared__ float red[kRowThreads / 32];
  __shared__ float shared_max;
  const int b = blockIdx.y, i = blockIdx.x;
  const float* row = ls + ((size_t)b * n1 + i) * m1;
  const float* vb = v + (size_t)b * m1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float m = -INFINITY;
  for (int j = threadIdx.x; j < m1; j += kRowThreads) m = fmaxf(m, row[j] + vb[j]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kRowThreads / 32 ? red[lane] : -INFINITY;
    m = warp_max(m);
    if (lane == 0) shared_max = isfinite(m) ? m : 0.f;
  }
  __syncthreads();
  m = shared_max;

  float s = 0.f;
  for (int j = threadIdx.x; j < m1; j += kRowThreads) s += expf((row[j] + vb[j]) - m);
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kRowThreads / 32 ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) u[(size_t)b * n1 + i] = log_mu[(size_t)b * n1 + i] - (logf(s) + m);
  }
}

// Column sweep: v[j] = log_nu[j] - LSE_i(S[i, j] + u[i]). One CTA per
// kColWidth columns; threadIdx.x picks the column, threadIdx.y the row lane.
__global__ void col_lse_kernel(const float* __restrict__ ls,
                               const float* __restrict__ log_nu,
                               const float* __restrict__ u,
                               float* __restrict__ v, int n1, int m1) {
  __shared__ float red[kColLanes][kColWidth + 1];
  const int b = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kColWidth + tx;
  const bool live = j < m1;
  const float* mat = ls + (size_t)b * n1 * m1;
  const float* ub = u + (size_t)b * n1;

  float m = -INFINITY;
  if (live)
    for (int i = ty; i < n1; i += kColLanes) m = fmaxf(m, mat[(size_t)i * m1 + j] + ub[i]);
  red[ty][tx] = m;
  __syncthreads();
  if (ty == 0) {
    for (int l = 1; l < kColLanes; ++l) m = fmaxf(m, red[l][tx]);
    red[0][tx] = isfinite(m) ? m : 0.f;
  }
  __syncthreads();
  m = red[0][tx];
  __syncthreads();  // every lane has read the max before red is reused

  float s = 0.f;
  if (live)
    for (int i = ty; i < n1; i += kColLanes) s += expf((mat[(size_t)i * m1 + j] + ub[i]) - m);
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && live) {
    for (int l = 1; l < kColLanes; ++l) s += red[l][tx];
    v[(size_t)b * m1 + j] = log_nu[(size_t)b * m1 + j] - (logf(s) + m);
  }
}

// P = exp(S + u + v), summed in that order as the twin does.
__global__ void transport_kernel(const float* __restrict__ ls,
                                 const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 float* __restrict__ p, int b, int n1, int m1) {
  const size_t total = (size_t)b * n1 * m1;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t row = e / m1;  // b * n1 + i
    const size_t bj = (row / n1) * m1 + e % m1;
    p[e] = expf((ls[e] + u[row]) + v[bj]);
  }
}

}  // namespace

// ls (b, n1, m1), log_mu (b, n1), log_nu (b, m1) f32 -> p (b, n1, m1).
// u (b, n1) is scratch; v (b, m1) must hold zeros on entry. Returns the
// first non-zero cudaGetLastError() among the launches, else 0.
extern "C" int oip_sinkhorn(const float* ls, const float* log_mu,
                            const float* log_nu, float* u, float* v, float* p,
                            int b, int n1, int m1, int iters, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 row_grid(n1, b);
  const dim3 col_grid((m1 + kColWidth - 1) / kColWidth, b);
  const dim3 col_block(kColWidth, kColLanes);
  for (int it = 0; it < iters; ++it) {
    row_lse_kernel<<<row_grid, kRowThreads, 0, st>>>(ls, log_mu, v, u, n1, m1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    col_lse_kernel<<<col_grid, col_block, 0, st>>>(ls, log_nu, u, v, n1, m1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t total = (size_t)b * n1 * m1;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  transport_kernel<<<blocks, 256, 0, st>>>(ls, u, v, p, b, n1, m1);
  return (int)cudaGetLastError();
}
