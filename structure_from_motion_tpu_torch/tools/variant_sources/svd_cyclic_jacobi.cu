// The first design of kernel B7, kept as the yardstick of
// tools/kernel_variants.py's b7 group (csrc/svd.cu is the kernel): a cyclic
// one-sided Jacobi for every null vector, three group sums a pair, and a
// tall matrix reduced by 256-row blocks in two to four launches.
//
// Kernel B7: small batched SVDs of the frame path, with no host read.
//
// No Pallas kernel of the JAX package stands behind this one: the JAX
// package leaves its SVDs to XLA, whose device SVD returns without the host.
// torch.linalg.svd on the card reads cuSOLVER's status on the host after
// every call, so each of a frame's small SVDs (the F-gate's eight-point
// fits and refits, the PnP DLT, the triangulation rows, the 3 x 3 factors)
// stops the host and keeps the stretch around it out of a CUDA graph. This
// kernel computes what ops/linalg.nullspace and the 3 x 3 torch.linalg.svd
// calls take, and decides everything on the device.
//
// Design (simple and exact rather than fast):
// * one-sided (Hestenes) Jacobi on the matrix itself, never on its gram
//   matrix (which squares the condition number in f32): column pairs are
//   rotated until, in a whole sweep, every pair's inner product is below
//   rows * FLT_EPSILON of their norms' product or below rows *
//   FLT_EPSILON^2 |A|_F^2 (f32 sums resolve no less; a column fallen to
//   rounding noise, as a rank-deficient matrix's does, must not keep the
//   sweeps going), or for 30 sweeps; V accumulates the rotations. The
//   singular values are the final column norms.
// * null vectors (ops/linalg.nullspace): a group of G = 4..32 lanes holds
//   one matrix of at most G rows, lane r its row r of A and row r of V;
//   every column sum is a butterfly over the group, whose result is the
//   same bits in every lane (each lane adds the same two partners), so the
//   group takes every decision together. The null vector is V's column of
//   the smallest norm (the last one among equals).
// * a taller matrix is reduced first, on the device, to an upper
//   triangular R with the same right singular vectors: each block of 256
//   threads takes 256 rows (one a thread) through N Householder steps and
//   writes its N x N R; the stacked R blocks are reduced again until at
//   most 32 rows are left (65,536 x 12: three reductions).
// * the 3 x 3 factors (U, S, Vh): one thread a matrix, the same rotations;
//   U's columns are A's rotated columns over their norms, completed by an
//   orthogonal vector and a cross product where a singular value is 0.
// * sign rule, as the plain version (ops/small_svd.py) applies it to
//   torch.linalg.svd: every right singular vector has its largest
//   component (the first among equals in magnitude) positive, and its left
//   singular vector takes the same sign.
//
// Bound: the tall null vectors by their bytes (the matrix read once); the
// small batches by their operations (ops/small_svd.py counts one QR's
// 2 M N^2 - 2 N^3 / 3 flops a matrix as the least an SVD does). Every sum
// has a fixed order, so a launch gives the same bits every time.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kChunk = 256;     // rows a reduction block takes, one a thread
constexpr int kMaxRows = 32;    // rows the Jacobi kernel takes directly
constexpr int kMaxSweeps = 30;  // LAPACK's sgesvj cap

__device__ __forceinline__ float rotation_t(float alpha, float beta, float gamma) {
  // tan of the angle that makes columns p, q orthogonal (Rutishauser's
  // smaller root of t^2 + 2 zeta t - 1 = 0)
  const float zeta = (beta - alpha) / (2.0f * gamma);
  if (fabsf(zeta) > 1.0e15f) return 0.5f / zeta;
  return copysignf(1.0f, zeta) / (fabsf(zeta) + sqrtf(fmaf(zeta, zeta, 1.0f)));
}

template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// A (batch, M, N) row-major, M <= G -> out (batch, N): the unit null vector.
template <int N, int G>
__global__ void null_jacobi(const float* __restrict__ A, int batch, int M,
                            float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = lane & (G - 1);
  const long long mat = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (mat >= batch) return;  // the whole group leaves together
  const unsigned mask = G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (lane & ~(G - 1)));
  float a[N], v[N];
  const float* src = A + (mat * M + r) * N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = r < M ? src[j] : 0.0f;
    v[j] = r == j ? 1.0f : 0.0f;
  }
  float norm2 = 0.0f;  // |A|_F^2
#pragma unroll
  for (int j = 0; j < N; ++j) norm2 += group_sum<G>(a[j] * a[j], mask);
  const float tol = M * FLT_EPSILON, abs_tol = tol * FLT_EPSILON * norm2;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float alpha = group_sum<G>(a[p] * a[p], mask);
        const float beta = group_sum<G>(a[q] * a[q], mask);
        const float gamma = group_sum<G>(a[p] * a[q], mask);
        if (fabsf(gamma) > fmaxf(tol * sqrtf(alpha) * sqrtf(beta), abs_tol)) {
          const float t = rotation_t(alpha, beta, gamma);
          const float c = rsqrtf(fmaf(t, t, 1.0f)), s = c * t;
          const float ap = a[p], aq = a[q], vp = v[p], vq = v[q];
          a[p] = c * ap - s * aq;
          a[q] = s * ap + c * aq;
          v[p] = c * vp - s * vq;
          v[q] = s * vp + c * vq;
          rotated = true;
        }
      }
    }
    if (!rotated) break;
  }
  // the column of the smallest norm (the last among equals)
  float best = group_sum<G>(a[0] * a[0], mask), x = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const float n2 = group_sum<G>(a[j] * a[j], mask);
    if (n2 <= best) {
      best = n2;
      x = v[j];
    }
  }
  // sign rule: the largest component (the first among equals) positive
  float mag = r < N ? fabsf(x) : -1.0f, val = x;
  int idx = r;
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(mask, mag, o);
    const float v2 = __shfl_xor_sync(mask, val, o);
    const int i2 = __shfl_xor_sync(mask, idx, o);
    if (m2 > mag || (m2 == mag && i2 < idx)) {
      mag = m2;
      val = v2;
      idx = i2;
    }
  }
  if (r < N) out[mat * N + r] = val < 0.0f ? -x : x;
}

// Rows [c * kChunk, (c + 1) * kChunk) of matrix b of A (batch, M, N) ->
// their N x N upper triangular R at rows [c * N, (c + 1) * N) of matrix b
// of R (batch, chunks * N, N); block (b * chunks + c), one row a thread.
template <int N>
__global__ void __launch_bounds__(kChunk) qr_chunk(const float* __restrict__ A, int M,
                                                   int chunks, float* __restrict__ R) {
  constexpr int kWarps = kChunk / 32;
  __shared__ float part[kWarps][N];
  __shared__ float pivot_row[N];
  const long long b = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const int r = threadIdx.x, lane = r & 31, warp = r >> 5;
  const long long row = (long long)c * kChunk + r;
  float a[N];
  const float* src = A + (b * M + row) * N;
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = row < M ? src[j] : 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // w_j = sum over rows r >= k of a_rk a_rj (w_k: the column's norm^2)
    const float xk = r >= k ? a[k] : 0.0f;
#pragma unroll
    for (int j = k; j < N; ++j) {
      const float w = group_sum<32>(xk * a[j], 0xffffffffu);
      if (lane == 0) part[warp][j] = w;
    }
    if (r == k) {
#pragma unroll
      for (int j = k; j < N; ++j) pivot_row[j] = a[j];
    }
    __syncthreads();
    float w[N];
#pragma unroll
    for (int j = k; j < N; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) s += part[i][j];
      w[j] = s;
    }
    const float akk = pivot_row[k], norm2 = w[k];
    float pk[N];
#pragma unroll
    for (int j = k; j < N; ++j) pk[j] = pivot_row[j];
    __syncthreads();  // part and pivot_row are written again at step k + 1
    if (norm2 > 0.0f) {
      // H = I - 2 u u^T / (u^T u), u = x - alpha e_k, alpha = -sign(a_kk) |x|
      const float alpha = -copysignf(sqrtf(norm2), akk);
      const float utu = 2.0f * (norm2 - alpha * akk);
      const float u = r == k ? akk - alpha : xk;
#pragma unroll
      for (int j = k + 1; j < N; ++j) a[j] -= (2.0f * (w[j] - alpha * pk[j]) / utu) * u;
      a[k] = r == k ? alpha : (r > k ? 0.0f : a[k]);
    }
  }
  if (r < N) {
    float* dst = R + ((b * chunks + c) * N + r) * N;
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = a[j];
  }
}

// A (batch, 3, 3) -> U (batch, 3, 3), S (batch, 3) descending, Vh (batch, 3, 3).
__global__ void svd3(const float* __restrict__ A, int batch, float* __restrict__ U,
                     float* __restrict__ S, float* __restrict__ Vh) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= batch) return;
  float a[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = A[m * 9 + i * 3 + j];
      v[i][j] = i == j ? 1.0f : 0.0f;
    }
  }
  float norm2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) norm2 += a[i][0] * a[i][0] + a[i][1] * a[i][1] + a[i][2] * a[i][2];
  const float tol = 3.0f * FLT_EPSILON, abs_tol = tol * FLT_EPSILON * norm2;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pq == 2 ? 1 : 0, q = pq == 0 ? 1 : 2;
      float alpha = 0.0f, beta = 0.0f, gamma = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        alpha += a[i][p] * a[i][p];
        beta += a[i][q] * a[i][q];
        gamma += a[i][p] * a[i][q];
      }
      if (fabsf(gamma) > fmaxf(tol * sqrtf(alpha) * sqrtf(beta), abs_tol)) {
        const float t = rotation_t(alpha, beta, gamma);
        const float c = rsqrtf(fmaf(t, t, 1.0f)), s = c * t;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float ap = a[i][p], aq = a[i][q], vp = v[i][p], vq = v[i][q];
          a[i][p] = c * ap - s * aq;
          a[i][q] = s * ap + c * aq;
          v[i][p] = c * vp - s * vq;
          v[i][q] = s * vp + c * vq;
        }
        rotated = true;
      }
    }
    if (!rotated) break;
  }
  float sig[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    sig[j] = sqrtf(a[0][j] * a[0][j] + a[1][j] * a[1][j] + a[2][j] * a[2][j]);
  // descending, equal values in column order
  int o[3] = {0, 1, 2};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2 - i; ++j) {
      if (sig[o[j + 1]] > sig[o[j]]) {
        const int t = o[j];
        o[j] = o[j + 1];
        o[j + 1] = t;
      }
    }
  }
  float u[3][3], vs[3][3];  // u[i]: left singular vector i; vs[i]: right one
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = o[i];
    const float s = sig[j];
    const bool ok = s > 0.0f && s >= 1.0e-30f * sig[o[0]];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      vs[i][k] = v[k][j];
      u[i][k] = ok ? a[k][j] / s : 0.0f;
    }
    if (!ok) {  // complete U: a unit vector orthogonal to the columns before
      if (i == 0) {
        u[0][0] = 1.0f;
      } else if (i == 1) {
        int e = 0;  // the axis least along u0 (the first among equals)
        if (fabsf(u[0][1]) < fabsf(u[0][e])) e = 1;
        if (fabsf(u[0][2]) < fabsf(u[0][e])) e = 2;
        float n2 = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          u[1][k] = (k == e ? 1.0f : 0.0f) - u[0][e] * u[0][k];
          n2 += u[1][k] * u[1][k];
        }
        const float inv = rsqrtf(n2);
#pragma unroll
        for (int k = 0; k < 3; ++k) u[1][k] *= inv;
      } else {
        u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
        u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
        u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
      }
    }
    // sign rule
    int big = 0;
    if (fabsf(vs[i][1]) > fabsf(vs[i][big])) big = 1;
    if (fabsf(vs[i][2]) > fabsf(vs[i][big])) big = 2;
    const float sg = vs[i][big] < 0.0f ? -1.0f : 1.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      vs[i][k] *= sg;
      u[i][k] *= sg;
    }
    S[m * 3 + i] = s;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      U[m * 9 + k * 3 + i] = u[i][k];
      Vh[m * 9 + i * 3 + k] = vs[i][k];
    }
  }
}

template <int N>
void launch_null(const float* A, int batch, int M, float* V, cudaStream_t stream) {
  // a group holds max(M, N) rows: A's and V's
  constexpr int kThreads = 128;
  const int rows = M > N ? M : N;
  const int G = rows <= 4 ? 4 : rows <= 8 ? 8 : rows <= 16 ? 16 : 32;
  const unsigned blocks = (unsigned)(((long long)batch * G + kThreads - 1) / kThreads);
  if constexpr (N <= 4) {
    if (G == 4) {
      null_jacobi<N, 4><<<blocks, kThreads, 0, stream>>>(A, batch, M, V);
      return;
    }
  }
  if constexpr (N <= 8) {
    if (G == 8) {
      null_jacobi<N, 8><<<blocks, kThreads, 0, stream>>>(A, batch, M, V);
      return;
    }
  }
  if (G == 16) {
    null_jacobi<N, 16><<<blocks, kThreads, 0, stream>>>(A, batch, M, V);
  } else {
    null_jacobi<N, 32><<<blocks, kThreads, 0, stream>>>(A, batch, M, V);
  }
}

template <int N>
int null_vectors(const float* A, int batch, int M, float* scratch, long long half, float* V,
                 cudaStream_t stream) {
  const float* src = A;
  int rows = M, side = 0;
  while (rows > kMaxRows) {
    const int chunks = (rows + kChunk - 1) / kChunk;
    if ((long long)batch * chunks * N * N > half) return (int)cudaErrorInvalidValue;
    float* dst = scratch + side * half;
    qr_chunk<N><<<(unsigned)((long long)batch * chunks), kChunk, 0, stream>>>(src, rows, chunks,
                                                                             dst);
    src = dst;
    rows = chunks * N;
    side ^= 1;
  }
  launch_null<N>(src, batch, rows, V, stream);
  return 0;
}

}  // namespace

// A (batch, M, N) f32 row-major. full = 1 (M = N = 3): U, S, Vh of every
// matrix. full = 0 (N = 4, 9 or 12, any M): V (batch, N), the unit null
// vector of every matrix; scratch holds 2 * half floats for the reductions
// of a matrix taller than 32 rows (ops/small_svd.py sizes it).
extern "C" int sfm_small_svd(const float* A, int batch, int M, int N, int full, float* scratch,
                             long long half, float* U, float* S, float* V, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (full) {
    if (M != 3 || N != 3) return (int)cudaErrorInvalidValue;
    svd3<<<(unsigned)((batch + 127) / 128), 128, 0, stream>>>(A, batch, U, S, V);
    return (int)cudaGetLastError();
  }
  int rc;
  switch (N) {
    case 4: rc = null_vectors<4>(A, batch, M, scratch, half, V, stream); break;
    case 9: rc = null_vectors<9>(A, batch, M, scratch, half, V, stream); break;
    case 12: rc = null_vectors<12>(A, batch, M, scratch, half, V, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return rc ? rc : (int)cudaGetLastError();
}
