// Essential-matrix solve kernels for Hopper (sm_90a): the 9x9 minimum
// eigenvector, the projection onto the essential manifold and the RANSAC
// hypothesis solve.
//
// Replaces no Pallas kernel. The JAX package runs these steps in XLA inside
// its jit, outside any pallas_call:
// onnx_image_processing_tpu/geometry/essential_matrix.py:101-102
// (jnp.linalg.eigh in min_eigvec9), :222-223 (jnp.linalg.svd in
// project_onto_essential_manifold) and :499-501 (the vmap of the hypothesis
// solve in essential_ransac_from_candidates). In the port they take the
// place of torch.linalg.eigh and torch.linalg.svd on a CUDA tensor, whose
// cuSOLVER calls copy a status to the host and check it in every solve (so
// no CUDA-graph capture), and of the ~2,000 small launches of the
// hypothesis stage's unrolled solve. Plain twins: min_eigvec9_plain,
// project_essential_plain and essential_hypotheses_plain in
// onnx_image_processing_tpu_torch/kernels/essential_solve.py.
//
// What bounds them on this card: latency, not bytes or operations. A call
// is one 9x9 matrix (324 B in), one 3x3 matrix or 256 hypotheses (~26 KB
// in): a few CTAs on 132 SMs, each running a chain of dependent float64
// (K1, K2) or float32 (K3) operations. Design:
//   oip_min_eigvec9 (K1): one warp per matrix, A and V in shared memory in
//     float64. Cyclic Jacobi in a parallel order: a sweep is 9 rounds of 4
//     disjoint pairs (the circle method over 9 indices). Lanes 0-3 compute
//     a round's 4 angles, one each (a branch-free form: a divide, a root
//     and a reciprocal root), and shuffle them to the warp; the 4 rotations
//     are applied at once, lanes 0-8 rotating the rows of A (a column
//     each), then the columns of A and V (a row each); 3 warp barriers a
//     round. (Every lane computing all 4 angles in turn, the first version,
//     took 0.082 ms a solve on an H100.) It stops when the off-diagonal
//     Frobenius norm is at most 1e-14 of the input's, or after 20 sweeps.
//     Every lane makes that
//     test on the same shared values, so the loop exit is warp-uniform and
//     reads nothing on the host. The result is the column of V at the
//     smallest diagonal entry, the lowest index on ties (an all-zero matrix
//     gives e0, as LAPACK does).
//   oip_project_essential (K2): one thread per matrix, float64 in
//     registers. Jacobi on E^T E (3x3) gives V; E' = s (u1 v1^T + u2 v2^T)
//     with s_i = |E v_i|, u_i = E v_i / s_i and s = (s1 + s2) / 2. The third
//     singular pair is multiplied by 0, so the twin's det-sign fix of u3
//     and v3 does not enter, and the sum does not depend on the signs of
//     the pairs (u_i, v_i).
//   oip_essential_hypotheses (K3): one thread per hypothesis, float32 in
//     registers: the twin's weighted Hartley normalisation, the 9x9 normal
//     matrix, one Cholesky factor of M + delta I (the twin factors the same
//     matrix in each of its three steps), three steps of inverse iteration
//     and the transposed denormalisation.
// All three are deterministic (no atomics; every sum in one fixed order),
// so a CUDA-graph replay equals an eager call bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kN = 9;                 // size of the normal matrix
constexpr int kPairs = 4;             // disjoint pairs rotated in one round
constexpr int kMaxSweeps = 20;        // cap on the Jacobi sweeps
constexpr double kOffTol = 1e-14;     // off-diagonal norm / input norm at exit
constexpr int kEigWarps = 4;          // K1: matrices (warps) per CTA
constexpr int kThreads = 128;         // K2, K3: threads per CTA, one item each
constexpr int kPoints = 8;            // K3: points of a minimal sample
constexpr int kTri = kN * (kN + 1) / 2;

// ---- K1: minimum eigenvector of a symmetric 9x9 matrix -------------------

struct Jacobi9 {
  double a[kN][kN];   // the matrix, rotated in place
  double v[kN][kN];   // the product of the rotations: eigenvectors as columns
};

// The rotation J (J_pp = J_qq = c, J_pq = s, J_qp = -s) for which
// (J^T A J)_pq = 0, with |angle| <= pi/4: t = tan(angle) =
// sgn(x) y / (|x| + |(x, y)|), x = a_qq - a_pp, y = 2 a_pq (the classic
// sgn(theta) / (|theta| + sqrt(theta^2 + 1)), theta = x / y, without its
// first divide). No branch: t = 0 where a_pq = 0.
__device__ __forceinline__ void jacobi_angle(double app, double aqq, double apq, double* c,
                                             double* s) {
  const double x = aqq - app, y = 2.0 * apq;
  const double t = apq == 0.0 ? 0.0 : (x < 0.0 ? -y : y) / (fabs(x) + sqrt(x * x + y * y));
  *c = rsqrt(1.0 + t * t);
  *s = t * *c;
}

// The 4 pairs (p < q) of round r, (r + k) % 9 with (r - k) % 9 for
// k = 1..4; index r sits out. Over the 9 rounds of a sweep each of the 36
// pairs comes once.
__device__ __forceinline__ void round_pairs(int r, int p[kPairs], int q[kPairs]) {
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int x = (r + k + 1) % kN, y = (r + kN - k - 1) % kN;
    p[k] = x < y ? x : y;
    q[k] = x < y ? y : x;
  }
}

// A <- J^T A on column j: rows p and q of each pair mix.
__device__ __forceinline__ void rotate_rows(Jacobi9& m, int j, const int p[kPairs],
                                            const int q[kPairs], const double c[kPairs],
                                            const double s[kPairs]) {
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const double ap = m.a[p[k]][j], aq = m.a[q[k]][j];
    m.a[p[k]][j] = c[k] * ap - s[k] * aq;
    m.a[q[k]][j] = s[k] * ap + c[k] * aq;
  }
}

// A <- A J and V <- V J on row i: columns p and q of each pair mix. The
// entry the rotation annihilates, (p, q) or (q, p), is set to 0.
__device__ __forceinline__ void rotate_cols(Jacobi9& m, int i, const int p[kPairs],
                                            const int q[kPairs], const double c[kPairs],
                                            const double s[kPairs]) {
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const double ap = m.a[i][p[k]], aq = m.a[i][q[k]];
    double np = c[k] * ap - s[k] * aq, nq = s[k] * ap + c[k] * aq;
    if (s[k] != 0.0) {
      if (i == p[k]) nq = 0.0;
      if (i == q[k]) np = 0.0;
    }
    m.a[i][p[k]] = np;
    m.a[i][q[k]] = nq;
    const double vp = m.v[i][p[k]], vq = m.v[i][q[k]];
    m.v[i][p[k]] = c[k] * vp - s[k] * vq;
    m.v[i][q[k]] = s[k] * vp + c[k] * vq;
  }
}

// Sum of squares of the entries above the diagonal, or of all of them.
__device__ __forceinline__ double sum_squares(const Jacobi9& m, bool all) {
  double acc = 0.0;
  for (int i = 0; i < kN; ++i)
    for (int j = all ? 0 : i + 1; j < kN; ++j) acc += m.a[i][j] * m.a[i][j];
  return acc;
}

// Entry e (row-major) of the input: the lower triangle, mirrored (LAPACK's
// eigh reads the lower triangle), in float64; V starts as the identity.
__device__ __forceinline__ void load_entry(Jacobi9& m, const float* src, int e) {
  const int i = e / kN, j = e % kN;
  m.a[i][j] = (double)(i >= j ? src[i * kN + j] : src[j * kN + i]);
  m.v[i][j] = i == j ? 1.0 : 0.0;
}

// Index of the smallest diagonal entry, the lowest on ties.
__device__ __forceinline__ int smallest_diagonal(const Jacobi9& m) {
  int best = 0;
  for (int i = 1; i < kN; ++i)
    if (m.a[i][i] < m.a[best][best]) best = i;
  return best;
}

// ---- K2: projection onto the essential manifold ----------------------------

// Eigenvectors (columns of v) and eigenvalues (diagonal of b, in place) of a
// symmetric 3x3 matrix, by cyclic Jacobi with the exit test of K1.
__device__ __forceinline__ void jacobi3(double b[3][3], double v[3][3]) {
  double norm2 = 0.0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      v[i][j] = i == j ? 1.0 : 0.0;
      norm2 += b[i][j] * b[i][j];
    }
  const double tol = kOffTol * kOffTol * norm2;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    if (!(b[0][1] * b[0][1] + b[0][2] * b[0][2] + b[1][2] * b[1][2] > tol)) break;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = k == 2 ? 1 : 0, q = k == 0 ? 1 : 2;   // (0, 1), (0, 2), (1, 2)
      double c, s;
      jacobi_angle(b[p][p], b[q][q], b[p][q], &c, &s);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const double bp = b[p][j], bq = b[q][j];
        b[p][j] = c * bp - s * bq;
        b[q][j] = s * bp + c * bq;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const double bp = b[i][p], bq = b[i][q];
        b[i][p] = c * bp - s * bq;
        b[i][q] = s * bp + c * bq;
        const double vp = v[i][p], vq = v[i][q];
        v[i][p] = c * vp - s * vq;
        v[i][q] = s * vp + c * vq;
      }
      if (s != 0.0) b[p][q] = b[q][p] = 0.0;
    }
  }
}

// E (row-major 3x3, float32) -> E' with singular values [s, s, 0].
__device__ __forceinline__ void project_essential_one(const float* in, float* out) {
  double e[3][3], b[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) e[i / 3][i % 3] = (double)in[i];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) b[r][c] = e[0][r] * e[0][c] + e[1][r] * e[1][c] + e[2][r] * e[2][c];
  jacobi3(b, v);
  // i1, i2: the two largest eigenvalues (i3, the null direction, the
  // smallest, lowest index on ties), i1 first.
  int i3 = 0;
  for (int i = 1; i < 3; ++i)
    if (b[i][i] < b[i3][i3]) i3 = i;
  int i1 = i3 == 0 ? 1 : 0, i2 = i3 == 2 ? 1 : 2;
  if (b[i2][i2] > b[i1][i1]) {
    const int t = i1;
    i1 = i2;
    i2 = t;
  }
  double u1[3], u2[3];
  for (int r = 0; r < 3; ++r) {
    u1[r] = e[r][0] * v[0][i1] + e[r][1] * v[1][i1] + e[r][2] * v[2][i1];
    u2[r] = e[r][0] * v[0][i2] + e[r][1] * v[1][i2] + e[r][2] * v[2][i2];
  }
  const double s1 = sqrt(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]);
  const double s2 = sqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]);
  if (!(s1 > 0.0)) {   // E = 0 gives 0; a NaN in E gives NaN
    for (int i = 0; i < 9; ++i) out[i] = (float)(s1 * 0.0);
    return;
  }
  for (int r = 0; r < 3; ++r) u1[r] /= s1;
  if (s2 > 0.0) {
    for (int r = 0; r < 3; ++r) u2[r] /= s2;
  } else {
    // Rank 1: any unit u2 orthogonal to u1 (the coordinate axis least
    // along u1, with u1 projected out).
    int k = 0;
    for (int r = 1; r < 3; ++r)
      if (fabs(u1[r]) < fabs(u1[k])) k = r;
    double n2 = 0.0;
    for (int r = 0; r < 3; ++r) {
      u2[r] = (r == k ? 1.0 : 0.0) - u1[k] * u1[r];
      n2 += u2[r] * u2[r];
    }
    const double n = sqrt(n2);
    for (int r = 0; r < 3; ++r) u2[r] /= n;
  }
  const double sbar = 0.5 * (s1 + s2);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      out[r * 3 + c] = (float)(sbar * (u1[r] * v[c][i1] + u2[r] * v[c][i2]));
}

// ---- K3: the RANSAC hypothesis solve -----------------------------------------

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }   // j <= i

// Weighted Hartley normalisation of one side: centroid and scale.
__device__ __forceinline__ void hartley8(const float w[kPoints], const float x[kPoints],
                                         const float y[kPoints], float wsum, float* cx,
                                         float* cy, float* scale) {
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    sx += w[i] * x[i];
    sy += w[i] * y[i];
  }
  *cx = sx / wsum;
  *cy = sy / wsum;
  float sd = 0.f;
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    const float dx = x[i] - *cx, dy = y[i] - *cy;
    sd += w[i] * (dx * dx + dy * dy);
  }
  const float mean = sqrtf(sd / wsum + 1e-8f);
  *scale = 1.41421356f / (mean + 1e-8f);
}

// One hypothesis: weights (8), points (8, 2) of each side -> E (3x3,
// row-major), the twin's essential_from_matched_points(method="fast",
// project=False).
__device__ __forceinline__ void essential_hypothesis(const float* w_in, const float* p1,
                                                     const float* p2, float* out) {
  float w[kPoints], x1[kPoints], y1[kPoints], x2[kPoints], y2[kPoints];
  float wsum = 0.f;
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    w[i] = w_in[i];
    x1[i] = p1[2 * i];
    y1[i] = p1[2 * i + 1];
    x2[i] = p2[2 * i];
    y2[i] = p2[2 * i + 1];
    wsum += w[i];
  }
  wsum += 1e-8f;
  float c1x, c1y, s1, c2x, c2y, s2;
  hartley8(w, x1, y1, wsum, &c1x, &c1y, &s1);
  hartley8(w, x2, y2, wsum, &c2x, &c2y, &s2);

  // M = A^T diag(w) A, design rows kron(h1, h2) (index a * 3 + b); the
  // lower triangle.
  float m[kTri];
#pragma unroll
  for (int i = 0; i < kTri; ++i) m[i] = 0.f;
#pragma unroll
  for (int n = 0; n < kPoints; ++n) {
    const float h1[3] = {(x1[n] - c1x) * s1, (y1[n] - c1y) * s1, 1.f};
    const float h2[3] = {(x2[n] - c2x) * s2, (y2[n] - c2y) * s2, 1.f};
    float a[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) a[i] = h1[i / 3] * h2[i % 3];
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) m[tri(i, j)] += a[i] * (w[n] * a[j]);
  }
  float trace = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) trace += m[tri(i, i)];
  // delta regularises the exactly singular case; it shifts the spectrum
  // uniformly, so the minimiser is unchanged.
  const float delta = 1e-6f * trace / 9.f + 1e-30f;

  float l[kTri];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = m[tri(i, j)] + (i == j ? delta : 0.f);
#pragma unroll
      for (int k = 0; k < j; ++k) s -= l[tri(i, k)] * l[tri(j, k)];
      l[tri(i, j)] = i == j ? sqrtf(fmaxf(s, 1e-30f)) : s / l[tri(j, j)];
    }

  float v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = 1.f / 3.f;
  for (int step = 0; step < 3; ++step) {
    float y[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      float s = v[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= l[tri(i, k)] * y[k];
      y[i] = s / l[tri(i, i)];
    }
#pragma unroll
    for (int i = kN - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < kN; ++k) s -= l[tri(k, i)] * v[k];
      v[i] = s / l[tri(i, i)];
    }
    float n2 = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i) n2 += v[i] * v[i];
    const float norm = sqrtf(n2) + 1e-30f;
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] /= norm;
  }

  // E = (T1^T E_raw T2)^T, T = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]],
  // E_raw[a][b] = v[a * 3 + b].
  const float t1[3][3] = {{s1, 0.f, -s1 * c1x}, {0.f, s1, -s1 * c1y}, {0.f, 0.f, 1.f}};
  const float t2[3][3] = {{s2, 0.f, -s2 * c2x}, {0.f, s2, -s2 * c2y}, {0.f, 0.f, 1.f}};
  float te[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      te[i][j] = t1[0][i] * v[j] + t1[1][i] * v[3 + j] + t1[2][i] * v[6 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[j * 3 + i] = te[i][0] * t2[0][j] + te[i][1] * t2[1][j] + te[i][2] * t2[2][j];
}

// ---- kernels -------------------------------------------------------------------

__global__ void __launch_bounds__(32 * kEigWarps)
min_eigvec9_kernel(const float* __restrict__ m, float* __restrict__ out, int b) {
  __shared__ Jacobi9 shared[kEigWarps];
  const int lane = threadIdx.x & 31;
  const int mat = blockIdx.x * kEigWarps + (threadIdx.x >> 5);
  if (mat >= b) return;   // the whole warp
  Jacobi9& s = shared[threadIdx.x >> 5];
  for (int e = lane; e < kN * kN; e += 32) load_entry(s, m + (size_t)mat * kN * kN, e);
  __syncwarp();
  const double tol = kOffTol * kOffTol * sum_squares(s, true);
  for (int sweep = 0; sweep < kMaxSweeps && sum_squares(s, false) > tol; ++sweep) {
    for (int r = 0; r < kN; ++r) {
      int p[kPairs], q[kPairs];
      double c[kPairs], sn[kPairs], my_c = 1.0, my_s = 0.0;
      round_pairs(r, p, q);
      if (lane < kPairs) {
        const int pl = p[lane], ql = q[lane];
        jacobi_angle(s.a[pl][pl], s.a[ql][ql], s.a[pl][ql], &my_c, &my_s);
      }
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        c[k] = __shfl_sync(0xffffffffu, my_c, k);
        sn[k] = __shfl_sync(0xffffffffu, my_s, k);
      }
      __syncwarp();
      if (lane < kN) rotate_rows(s, lane, p, q, c, sn);
      __syncwarp();
      if (lane < kN) rotate_cols(s, lane, p, q, c, sn);
      __syncwarp();
    }
  }
  const int k = smallest_diagonal(s);
  if (lane < kN) out[(size_t)mat * kN + lane] = (float)s.v[lane][k];
}

__global__ void __launch_bounds__(kThreads)
project_essential_kernel(const float* __restrict__ e, float* __restrict__ out, int b) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < b) project_essential_one(e + (size_t)i * 9, out + (size_t)i * 9);
}

__global__ void __launch_bounds__(kThreads)
essential_hypotheses_kernel(const float* __restrict__ w, const float* __restrict__ p1,
                            const float* __restrict__ p2, float* __restrict__ out, int s) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < s)
    essential_hypothesis(w + (size_t)i * kPoints, p1 + (size_t)i * 2 * kPoints,
                         p2 + (size_t)i * 2 * kPoints, out + (size_t)i * 9);
}

}  // namespace

// (b, 9, 9) float32 symmetric matrices -> (b, 9) float32 unit eigenvectors
// of their smallest eigenvalues.
extern "C" int oip_min_eigvec9(const float* m, float* out, int b, void* stream) {
  if (b > 0)
    min_eigvec9_kernel<<<(b + kEigWarps - 1) / kEigWarps, 32 * kEigWarps, 0,
                         (cudaStream_t)stream>>>(m, out, b);
  return (int)cudaGetLastError();
}

// (b, 3, 3) float32 -> (b, 3, 3) float32 with singular values [s, s, 0].
extern "C" int oip_project_essential(const float* e, float* out, int b, void* stream) {
  if (b > 0)
    project_essential_kernel<<<(b + kThreads - 1) / kThreads, kThreads, 0,
                               (cudaStream_t)stream>>>(e, out, b);
  return (int)cudaGetLastError();
}

// (s, 8) weights and (s, 8, 2) points of each side, float32 -> (s, 3, 3)
// float32 hypotheses.
extern "C" int oip_essential_hypotheses(const float* w, const float* p1, const float* p2,
                                        float* out, int s, void* stream) {
  if (s > 0)
    essential_hypotheses_kernel<<<(s + kThreads - 1) / kThreads, kThreads, 0,
                                  (cudaStream_t)stream>>>(w, p1, p2, out, s);
  return (int)cudaGetLastError();
}
