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
// What bounds it on an H100: neither bytes nor flops. The matrices are
// small (a 2048 x 8 x 9 batch is 0.6 MB and 2.4 MFLOP), so the time is the
// chain of dependent steps a matrix needs: shuffles, barriers, square roots
// and quotients. Each design below shortens that chain for one family of
// shapes.
//
// * Wide matrices, M < N (the eight-point fits, 8 x 9): the null vector is
//   the last column of the full Q of a Householder QR of A^T, orthogonal to
//   A's row space whatever its rank (a repeated sample still gives a unit
//   vector with |A v| at rounding level). No sweeps, no convergence test.
//   One thread a matrix holds its N - 1 reflected rows in registers (72
//   floats at 8 x 9, 96 registers, no spill); a warp stages its 32 matrices
//   through shared memory (stride N (N - 1) + 1, odd: no bank conflicts)
//   with every load in flight before the first store, so that its loads are
//   coalesced and overlap. Q e_N is the reflectors applied to e_N in
//   reverse order.
// * Square and short matrices, N <= M <= 32 (12 x 12 PnP fits, 4 x 4
//   triangulation rows) and the N x N left by a tall matrix: one-sided
//   (Hestenes) Jacobi on the matrix itself, never on its gram matrix (which
//   squares the condition number in f32). A group of G lanes holds one
//   matrix, a row a lane (row r of A and of V in lane r; a narrower group
//   holds rows r + s G in slots s); a column sum is a butterfly over the
//   group, whose result is the same bits in every lane
//   (each lane adds the same two partners), so the group takes every
//   decision together.
//   - The column pairs go in a parallel (round-robin) order: N/2 disjoint
//     pairs a round, at fixed positions (i, N-1-i), the columns moved one
//     place on after each round (N = 9 padded with a zero column); N - 1
//     rounds a sweep bring every column back to its place. A round's N/2
//     inner products are summed together, so their shuffles overlap.
//   - One group sum a pair, not three: the column norms are carried across
//     rotations (alpha' = alpha - t gamma, beta' = beta + t gamma, as
//     LAPACK's sgesvj does) and recomputed from the columns once a sweep.
//   - No branch a pair: a pair that passes the test turns by t = 0, which
//     keeps its bits, and t comes from approximate roots and quotients
//     (t = sign(d) e / (|d| + sqrt(d^2 + e^2)), d = beta - alpha, e =
//     2 gamma), so the rotations of a round overlap. In a round of three
//     pairs or more, lane i works t out for pair i and the group takes it
//     by a shuffle.
//   - A pair is rotated unless its inner product is below rows *
//     FLT_EPSILON of their norms' product or below rows * FLT_EPSILON^2
//     |A|_F^2 (f32 sums resolve no less; a column fallen to rounding noise,
//     as a rank-deficient matrix's does, must not keep the sweeps going);
//     a sweep with no rotation ends it, 30 sweeps at most. The null vector
//     is V's column of the smallest norm (the last one among equals).
// * Tall matrices, M > 32 (the LO refits: 16 x 2048 x 9, 1 x n x 12 up to
//   n = 65,536), in ONE launch. A matrix of at most kOneBlock rows is one
//   block of kTallThreads threads (kRowsOne rows a thread) that reduces it
//   by N Householder steps to an upper triangular N x N R with the same
//   right singular vectors and runs the Jacobi above on R. A taller matrix
//   is shared by blocks of kChunkRows rows: each writes its R, fences and
//   takes a ticket from its matrix's counter; the block that draws the last
//   ticket stacks the matrix's R's IN BLOCK ORDER (so the bits do not
//   depend on which block finished last), reduces them the same way
//   (kChunkRows - N new rows at a time below the running R) and runs the
//   Jacobi. The counters are zeroed by a memset in the launch's stream
//   order (a CUDA graph captures it), never by the host. A step's column
//   sums go lanes, then warps (one thread a column, in warp order), then
//   every thread, with two barriers.
// * The 3 x 3 factors (U, S, Vh): one thread a matrix, the same rotations
//   in cyclic order with IEEE roots; U's columns are A's rotated columns
//   over their norms, completed by an orthogonal vector and a cross product
//   where a singular value is 0. At the launch floor: unchanged.
// * Sign rule, as the plain version (ops/small_svd.py) applies it to
//   torch.linalg.svd: every right singular vector has its largest component
//   (the first among equals in magnitude) positive, and its left singular
//   vector takes the same sign.
//
// No float atomics, and every sum has a fixed order, so a launch gives the
// same bits every time, and so does every replay of a captured graph.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUDA-event time of one
// call, warm, the first design in the same run: a cyclic one-sided Jacobi
// for every null vector, a tall matrix reduced by 256-row blocks in two to
// four launches):
// 2048 x 8 x 9 0.1016 -> 0.0094 ms (5.1-5.5 us device), 16 x 8 x 9 0.0844
// -> 0.0085; 1024 x 12 x 12 0.2088-0.2092 -> 0.0544; 16 x 2048 x 9 0.0784
// -> 0.0340 (its QR 8 us of 30 device, the 9 x 9 Jacobi the rest); 1 x
// 16,384 / 32,768 / 65,536 x 12 0.1508 / 0.1503-0.1507 / 0.1529 -> 0.0551
// / 0.0536 / 0.0583-0.0586 (the QR passes 18-21 us of 48-54, the final
// 12 x 12 Jacobi the rest); 4 x 4 0.0120-0.0125 -> 0.0094. Tried and not
// kept (the same run; the 1024 x 12 x 12, 16 x 2048 x 9 and 65,536 x 12
// times):
// * every lane working out every rotation: 0.0641, 0.0436, 0.0750 ms;
//   spreading the 4 x 4's two rotations too: 4 x 4 0.0131;
// * a 12-column group of 8 lanes with two rows a lane: 0.0620 (12 x 12),
//   0.0645 (65,536); of 4 lanes with three: 0.0764, 0.0853; 9 columns on 8
//   lanes: 0.0366 (16 x 2048), on 4: 0.0499;
// * one round's code run in a loop (the sweep not unrolled): 0.0583,
//   0.0383, 0.0546 (6-10% faster on the lone tall 12 x 12, slower on the
//   batches and the 9 x 9, which a slice launches more often);
// * t from zeta = (beta - alpha) / 2 gamma (three approximate quotients and
//   roots): 0.0549, 0.0355, 0.0608;
// * reduction blocks: 2 or 8 rows a thread of a shared matrix, 0.0753 or
//   0.0651 at 65,536 rows; 128 or 512 threads, 0.0777 or 0.0633; a lone
//   2048-row block of 4 or 16 rows a thread, 0.0402 or 0.0377 (16 x 2048);
// * the wide matrices by the Jacobi: 0.0484 (2048 x 8 x 9), 0.0403 (16 x 8
//   x 9); their reflectors normalised by rsqrtf: 0.0090, 0.0082, no more
//   accurate against float64 than the IEEE ones, but a different RANSAC
//   winner on a near-degenerate sequence (chip_smoke.py's small batch).
//
// Bound (chip_smoke.py): the larger of the bytes (the matrix read once, the
// outputs written once) and one QR's 2 M N^2 - 2 N^3 / 3 flops a matrix, the
// least an SVD does; the null vectors sit at 40-300x it, latency-bound.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kMaxRows = 32;        // rows the Jacobi kernel takes directly
constexpr int kMaxSweeps = 30;      // LAPACK's sgesvj cap
constexpr int kLanes9 = 16;         // lanes a 9-column Jacobi group (a row a lane)
constexpr int kLanes12 = 16;        // lanes a 12-column Jacobi group (a row a lane)
constexpr int kSpreadPairs = 3;     // a round of this many pairs spreads its rotations
constexpr int kTallThreads = 256;   // threads a reduction block
constexpr int kRowsOne = 8;         // rows a thread when one block takes the whole matrix
constexpr int kRowsPerThread = 4;   // rows a thread when several blocks share it
constexpr int kOneBlock = kTallThreads * kRowsOne;
constexpr int kChunkRows = kTallThreads * kRowsPerThread;

// lanes and rows a lane of the Jacobi group that finishes an N-column matrix
template <int N>
struct Group {
  static constexpr int G = N == 9 ? kLanes9 : N == 12 ? kLanes12 : N <= 4 ? 4 : N <= 8 ? 8 : 16;
  static constexpr int R = (N + G - 1) / G;
};

__device__ __forceinline__ float rotation_t(float alpha, float beta, float gamma) {
  // tan of the angle that makes columns p, q orthogonal (Rutishauser's
  // smaller root of t^2 + 2 zeta t - 1 = 0)
  const float zeta = (beta - alpha) / (2.0f * gamma);
  if (fabsf(zeta) > 1.0e15f) return 0.5f / zeta;
  return copysignf(1.0f, zeta) / (fabsf(zeta) + sqrtf(fmaf(zeta, zeta, 1.0f)));
}

// the same root by the approximate intrinsics (no IEEE slow path, so the
// rotations of a round overlap): with d = beta - alpha and e = 2 gamma,
// t = sign(d) e / (|d| + sqrt(d^2 + e^2)) (d = 0: t = sign(e))
__device__ __forceinline__ float rotation_t_approx(float alpha, float beta, float gamma) {
  const float d = beta - alpha, e = 2.0f * gamma;
  const float h2 = fmaf(d, d, e * e);
  return __fdividef(copysignf(1.0f, d) * e, fabsf(d) + h2 * rsqrtf(h2));
}

__device__ __forceinline__ float approx_sqrt(float x) { return x > 0.0f ? x * rsqrtf(x) : 0.0f; }

// The exponent e of the largest |entry| m > 0 (kNoExponent for a zero
// matrix), within what 2^-e can hold: scaling by a power of two is exact,
// leaves the null vector's bits as they are, and keeps every square of a
// matrix whose entries reach 1e30 (a masked candidate's Hartley scale) from
// overflowing, as LAPACK's own scaling does for the plain version.
constexpr int kNoExponent = -1000;
__device__ __forceinline__ int scale_exponent(float m) {
  return m > 0.0f ? min(max(ilogbf(m), -126), 126) : kNoExponent;
}

// K butterfly sums over a group of G lanes, their shuffles interleaved
template <int G, int K>
__device__ __forceinline__ void group_sums(float (&x)[K], unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] += __shfl_xor_sync(mask, x[k], o);
  }
}

template <int N>
__host__ __device__ constexpr int padded() {
  return N + (N & 1);
}

// nrm[j] = |column j|^2 over the group, the same bits in every lane
template <int C, int G, int R>
__device__ __forceinline__ void column_norms(const float (&a)[R][C], float (&nrm)[C],
                                             unsigned mask) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    nrm[j] = 0.0f;
#pragma unroll
    for (int s = 0; s < R; ++s) nrm[j] = fmaf(a[s][j], a[s][j], nrm[j]);
  }
  group_sums<G, C>(nrm, mask);
}

// Positions 1..P-1 of x move one place on (the last to position 1): the
// round-robin (circle) order, in which the pairs at positions (i, P-1-i)
// of P - 1 rounds meet every pair of columns once and the columns end the
// sweep where they began.
template <int P>
__device__ __forceinline__ void shift_positions(float (&x)[P]) {
  const float last = x[P - 1];
#pragma unroll
  for (int k = P - 1; k >= 2; --k) x[k] = x[k - 1];
  x[1] = last;
}

// One-sided Jacobi on the M x N matrix whose rows r + s G (s < R) this lane
// holds in a (zero beyond M, and in the padding column); writes the unit
// null vector under the sign rule to dst[0..N).
template <int N, int G, int R>
__device__ void jacobi_null(float (&a)[R][padded<N>()], int M, int r, unsigned mask,
                            float* __restrict__ dst) {
  constexpr int P = padded<N>(), H = P / 2;
  float v[R][P];  // V's rows r + s G (the padding column stays 0)
#pragma unroll
  for (int s = 0; s < R; ++s) {
#pragma unroll
    for (int j = 0; j < P; ++j) v[s][j] = r + s * G == j && j < N ? 1.0f : 0.0f;
  }
  float big = 0.0f;  // the largest |entry|, the same in every lane
#pragma unroll
  for (int s = 0; s < R; ++s) {
#pragma unroll
    for (int j = 0; j < P; ++j) big = fmaxf(big, fabsf(a[s][j]));
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) big = fmaxf(big, __shfl_xor_sync(mask, big, o));
  if (big > 0.0f) {
    const float sc = ldexpf(1.0f, -scale_exponent(big));
#pragma unroll
    for (int s = 0; s < R; ++s) {
#pragma unroll
      for (int j = 0; j < P; ++j) a[s][j] *= sc;
    }
  }
  float nrm[P];  // column norms^2, the same bits in every lane of the group
  column_norms<P, G, R>(a, nrm, mask);
  float norm2 = 0.0f;  // |A|_F^2
#pragma unroll
  for (int j = 0; j < N; ++j) norm2 += nrm[j];
  const float tol = M * FLT_EPSILON, abs_tol = tol * FLT_EPSILON * norm2;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    // the sweep unrolled: the column shifts below are renamings
#pragma unroll
    for (int round = 0; round < P - 1; ++round) {
      float g[H];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        g[i] = 0.0f;
#pragma unroll
        for (int s = 0; s < R; ++s) g[i] = fmaf(a[s][i], a[s][P - 1 - i], g[i]);
      }
      group_sums<G, H>(g, mask);
      // t = 0 (a pair that passes the test, or the padding column, whose
      // inner products are 0) turns nothing and keeps the bits
      float t_pair[H];
      if constexpr (H >= kSpreadPairs && G >= H) {
        // lane i of the group works out pair i's rotation (lanes past H
        // repeat pair 0) and every lane takes each t by a shuffle: the
        // round's rotations are computed once, side by side
        float ga = g[0], al = nrm[0], be = nrm[P - 1];
#pragma unroll
        for (int i = 1; i < H; ++i) {
          if (r == i) {
            ga = g[i];
            al = nrm[i];
            be = nrm[P - 1 - i];
          }
        }
        const bool turn = fabsf(ga) > fmaxf(tol * approx_sqrt(al * be), abs_tol);
        const float t = turn ? rotation_t_approx(al, be, ga != 0.0f ? ga : 1.0f) : 0.0f;
        rotated |= (__ballot_sync(mask, turn) & mask) != 0u;
#pragma unroll
        for (int i = 0; i < H; ++i) t_pair[i] = __shfl_sync(mask, t, i, G);
      } else {
        // every lane works out every pair's rotation, with no branch
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float al = nrm[i], be = nrm[P - 1 - i], ga = g[i];
          const bool turn = fabsf(ga) > fmaxf(tol * approx_sqrt(al * be), abs_tol);
          t_pair[i] = turn ? rotation_t_approx(al, be, ga != 0.0f ? ga : 1.0f) : 0.0f;
          rotated |= turn;
        }
      }
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const int p = i, q = P - 1 - i;
        const float t = t_pair[i];
        const float c = t != 0.0f ? rsqrtf(fmaf(t, t, 1.0f)) : 1.0f, sn = c * t;
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const float ap = a[s][p], aq = a[s][q], vp = v[s][p], vq = v[s][q];
          a[s][p] = c * ap - sn * aq;
          a[s][q] = sn * ap + c * aq;
          v[s][p] = c * vp - sn * vq;
          v[s][q] = sn * vp + c * vq;
        }
        nrm[p] = fmaxf(fmaf(-t, g[i], nrm[p]), 0.0f);
        nrm[q] = fmaf(t, g[i], nrm[q]);
      }
      shift_positions<P>(nrm);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        shift_positions<P>(a[s]);
        shift_positions<P>(v[s]);
      }
    }
    column_norms<P, G, R>(a, nrm, mask);  // once a sweep, so that the carried norms do not drift
    if (!rotated) break;
  }
  // the column of the smallest norm (the last among equals)
  float best = nrm[0], x[R];
#pragma unroll
  for (int s = 0; s < R; ++s) x[s] = v[s][0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    if (nrm[j] <= best) {
      best = nrm[j];
#pragma unroll
      for (int s = 0; s < R; ++s) x[s] = v[s][j];
    }
  }
  // sign rule: the largest component (the first among equals) positive
  float mag = -1.0f, val = 0.0f;
  int idx = N;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    if (r + s * G < N && fabsf(x[s]) > mag) {
      mag = fabsf(x[s]);
      val = x[s];
      idx = r + s * G;
    }
  }
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
#pragma unroll
  for (int s = 0; s < R; ++s) {
    if (r + s * G < N) dst[r + s * G] = val < 0.0f ? -x[s] : x[s];
  }
}

template <int G>
__device__ __forceinline__ unsigned group_mask(int lane) {
  return G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (lane & ~(G - 1)));
}

// A (batch, M, N) row-major, N <= M <= G R -> out (batch, N): the unit null
// vector, one group of G lanes a matrix.
template <int N, int G, int R>
__global__ void __launch_bounds__(128) null_small(const float* __restrict__ A, int batch, int M,
                                                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = lane & (G - 1);
  const long long mat = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (mat >= batch) return;  // the whole group leaves together
  float a[R][padded<N>()];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int row = r + s * G;
    const float* src = A + (mat * M + (row < M ? row : 0)) * N;
#pragma unroll
    for (int j = 0; j < padded<N>(); ++j) a[s][j] = row < M && j < N ? src[j] : 0.0f;
  }
  jacobi_null<N, G, R>(a, M, r, group_mask<G>(lane), out + mat * N);
}

// A (batch, M, N) row-major, M < N -> out (batch, N): the last column of the
// full Q of a Householder QR of A^T, one thread a matrix, 32 a block.
template <int N>
__global__ void __launch_bounds__(32) null_wide(const float* __restrict__ A, int batch, int M,
                                                float* __restrict__ out) {
  constexpr int K = N - 1;          // rows a thread holds (M <= K; zero beyond M)
  constexpr int kStride = K * N + 1;  // odd: a thread's reads hit 32 banks
  __shared__ float stage[32 * kStride];
  const long long first = (long long)blockIdx.x * 32;
  const int count = (int)min(32LL, batch - first), mn = M * N;
  const float* src = A + first * mn;
  // coalesced, and every load of the warp in flight before the first store:
  // element e of the 32 matrices (at most 32 K N) goes to matrix e / mn
  const int total = count * mn;
  const float inv_mn = 1.0f / mn;
#pragma unroll
  for (int it = 0; it < K * N; ++it) {
    const int e = it * 32 + threadIdx.x;
    if (e < total) {
      const int m = (int)((e + 0.5f) * inv_mn);  // exact: e < 32 K N
      stage[m * kStride + e - m * mn] = src[e];
    }
  }
  __syncwarp();
  if ((int)threadIdx.x >= count) return;
  float a[K][N];
  const float* mine = stage + threadIdx.x * kStride;
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[i][j] = i < M ? mine[i * N + j] : 0.0f;
      amax = fmaxf(amax, fabsf(a[i][j]));
    }
  }
  if (amax > 0.0f) {
    const float sc = ldexpf(1.0f, -scale_exponent(amax));
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) a[i][j] *= sc;
    }
  }
  // step k reflects row k's entries k.. onto e_k; its unit reflector u
  // (H = I - 2 u u^T) stays in row k's entries k..; rows after k follow
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float norm2 = 0.0f;
#pragma unroll
    for (int j = k; j < N; ++j) norm2 = fmaf(a[k][j], a[k][j], norm2);
    const float akk = a[k][k];
    const float alpha = -copysignf(sqrtf(norm2), akk);
    const float half_utu = norm2 - alpha * akk;  // |x - alpha e_k|^2 / 2
    // IEEE root and quotient: u of unit length to the last bit keeps H
    // orthogonal (the approximate rsqrtf changed which RANSAC hypothesis won
    // on a near-degenerate sequence)
    const float inv = half_utu > 0.0f ? 1.0f / sqrtf(2.0f * half_utu) : 0.0f;
    a[k][k] = akk - alpha;
#pragma unroll
    for (int j = k; j < N; ++j) a[k][j] *= inv;  // unit u: H = I - 2 u u^T
#pragma unroll
    for (int i = k + 1; i < K; ++i) {
      float d = 0.0f;
#pragma unroll
      for (int j = k; j < N; ++j) d = fmaf(a[k][j], a[i][j], d);
      d *= 2.0f;
#pragma unroll
      for (int j = k; j < N; ++j) a[i][j] = fmaf(-d, a[k][j], a[i][j]);
    }
  }
  float x[N];
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = j == N - 1 ? 1.0f : 0.0f;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    float d = 0.0f;
#pragma unroll
    for (int j = k; j < N; ++j) d = fmaf(a[k][j], x[j], d);
    d *= 2.0f;
#pragma unroll
    for (int j = k; j < N; ++j) x[j] = fmaf(-d, a[k][j], x[j]);
  }
  // sign rule: the largest component (the first among equals) positive
  int big = 0;
#pragma unroll
  for (int j = 1; j < N; ++j) big = fabsf(x[j]) > fabsf(x[big]) ? j : big;
  float sign = 1.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) sign = j == big && x[j] < 0.0f ? -1.0f : sign;
  float* dst = out + (first + threadIdx.x) * N;
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j] = sign * x[j];
}

// Householder QR of the rows a reduction block holds: row r = t + i T in
// thread t, slot i (slots at or past `slots` hold no row). On return rows
// 0..N-1 (threads 0..N-1, slot 0) hold R and every other row is 0. Every
// thread computes the same reflector from the same shared sums.
template <int N, int T, int RPT>
__device__ void block_qr(float (&a)[RPT][N], int slots, float (*part)[T / 32][N],
                         float (*total)[N], float (*pivot)[N]) {
  constexpr int kWarps = T / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int buf = k & 1;  // two buffers: no barrier at the end of a step
    // w_j = sum over rows r >= k of a_rk a_rj (w_k: the column's norm^2)
    float w[N];
#pragma unroll
    for (int j = k; j < N; ++j) w[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (i < slots) {
        const float xk = i == 0 && t < k ? 0.0f : a[i][k];
#pragma unroll
        for (int j = k; j < N; ++j) w[j] = fmaf(xk, a[i][j], w[j]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = k; j < N; ++j) w[j] += __shfl_xor_sync(0xffffffffu, w[j], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = k; j < N; ++j) part[buf][warp][j] = w[j];
    }
    if (t == k) {
#pragma unroll
      for (int j = k; j < N; ++j) pivot[buf][j] = a[0][j];
    }
    __syncthreads();
    if (t < N - k) {  // thread t sums column k + t over the warps, in warp order
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += part[buf][q][k + t];
      total[buf][k + t] = s;
    }
    __syncthreads();
    float pk[N];
#pragma unroll
    for (int j = k; j < N; ++j) {
      w[j] = total[buf][j];
      pk[j] = pivot[buf][j];
    }
    const float akk = pk[k], norm2 = w[k];
    if (norm2 > 0.0f) {
      // H = I - 2 u u^T / (u^T u), u = x - alpha e_k, alpha = -sign(a_kk) |x|
      const float alpha = -copysignf(sqrtf(norm2), akk);
      const float scale = 1.0f / (norm2 - alpha * akk);  // 2 / u^T u
      float f[N];
#pragma unroll
      for (int j = k + 1; j < N; ++j) f[j] = (w[j] - alpha * pk[j]) * scale;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i < slots) {
          const bool head = i == 0 && t <= k;  // rows 0..k: R's, or the pivot
          const float u = i == 0 && t == k ? akk - alpha : (head ? 0.0f : a[i][k]);
#pragma unroll
          for (int j = k + 1; j < N; ++j) a[i][j] = fmaf(-f[j], u, a[i][j]);
          a[i][k] = i == 0 && t == k ? alpha : (head ? a[i][k] : 0.0f);
        }
      }
    }
  }
}

// Rows [0, count) of src into the block's rows (zero after them).
template <int N, int T, int RPT>
__device__ void load_rows(float (&a)[RPT][N], const float* __restrict__ src, int count) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = t + i * T;
    const float* p = src + (long long)(row < count ? row : 0) * N;
#pragma unroll
    for (int j = 0; j < N; ++j) a[i][j] = row < count ? p[j] : 0.0f;
  }
}

// Rows [start, start + count) of the stacked R's into the block's rows
// first.. (zero after them; rows before `first` keep the running R), each
// block's R taken from its scale 2^-e_c to the matrix's 2^-E. The loads
// bypass L1: other blocks wrote them in this launch.
template <int N, int T, int RPT>
__device__ void load_stack(float (&a)[RPT][N], const float* __restrict__ stack,
                           const int* __restrict__ exps, int E, int start, int first, int count) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = t + i * T;
    if (row < first) continue;
    const bool in = row - first < count;
    const int idx = in ? start + row - first : 0;
    const float f = in ? ldexpf(1.0f, __ldcg(exps + idx / N) - E) : 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) a[i][j] = in ? __ldcg(stack + idx * N + j) * f : 0.0f;
  }
}

// The largest |entry| of the block's rows, the same in every thread.
template <int N, int T, int RPT>
__device__ float block_max(const float (&a)[RPT][N], float* wmax) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float big = 0.0f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) big = fmaxf(big, fabsf(a[i][j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, o));
  if (lane == 0) wmax[warp] = big;
  __syncthreads();
  big = 0.0f;
#pragma unroll
  for (int q = 0; q < T / 32; ++q) big = fmaxf(big, wmax[q]);
  return big;
}

// A (batch, M, N), M > kMaxRows -> out (batch, N); block m * nblk + c
// reduces rows [c T RPT, (c + 1) T RPT) of matrix m. Rs (batch, nblk, N,
// N), the blocks' scale exponents (batch, nblk) and the counters (batch)
// are used only when nblk > 1.
template <int N, int T, int RPT>
__global__ void __launch_bounds__(T) null_tall(const float* __restrict__ A, int M, int nblk,
                                               float* __restrict__ Rs, int* __restrict__ exps,
                                               int* __restrict__ tickets,
                                               float* __restrict__ out) {
  constexpr int CH = T * RPT;
  __shared__ float part[2][T / 32][N];
  __shared__ float total[2][N];
  __shared__ float pivot[2][N];
  __shared__ float fin[N][N];
  __shared__ float wmax[T / 32];
  __shared__ int last;
  const int t = threadIdx.x;
  const long long m = blockIdx.x / nblk;
  const int c = blockIdx.x % nblk;
  const long long row0 = (long long)c * CH;
  const int rows = (int)min((long long)CH, M - row0);
  float a[RPT][N];
  load_rows<N, T, RPT>(a, A + (m * M + row0) * N, rows);
  const int e = scale_exponent(block_max<N, T, RPT>(a, wmax));
  if (e != kNoExponent) {
    const float sc = ldexpf(1.0f, -e);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) a[i][j] *= sc;
    }
  }
  block_qr<N, T, RPT>(a, (rows + T - 1) / T, part, total, pivot);
  if (nblk > 1) {
    float* stack = Rs + m * nblk * N * N;
    const int* mexps = exps + m * nblk;
    if (t < N) {
#pragma unroll
      for (int j = 0; j < N; ++j) stack[(c * N + t) * N + j] = a[0][j];
    }
    if (t == 0) exps[m * nblk + c] = e;
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(tickets + m, 1) == nblk - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    int E = kNoExponent;  // the matrix's: the largest block's
    for (int b = 0; b < nblk; ++b) E = max(E, __ldcg(mexps + b));
    // the stacked R's in block order, CH - N rows at a time below the
    // running R (the first pass takes CH rows)
    const int stacked = nblk * N;
    for (int start = 0, first = 0; start < stacked;) {
      const int count = min(CH - first, stacked - start);
      load_stack<N, T, RPT>(a, stack, mexps, E, start, first, count);
      block_qr<N, T, RPT>(a, (first + count + T - 1) / T, part, total, pivot);
      start += count;
      first = N;
    }
  }
  if (t < N) {
#pragma unroll
    for (int j = 0; j < N; ++j) fin[t][j] = a[0][j];
  }
  __syncthreads();
  using Gr = Group<N>;
  if (t >= Gr::G) return;
  float b[Gr::R][padded<N>()];
#pragma unroll
  for (int s = 0; s < Gr::R; ++s) {
    const int row = t + s * Gr::G;
#pragma unroll
    for (int j = 0; j < padded<N>(); ++j) b[s][j] = row < N && j < N ? fin[row][j] : 0.0f;
  }
  jacobi_null<N, Gr::G, Gr::R>(b, N, t, group_mask<Gr::G>(t), out + m * N);
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

template <int N, int G, int R>
void launch_small(const float* A, int batch, int M, float* V, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const unsigned blocks = (unsigned)(((long long)batch * G + kThreads - 1) / kThreads);
  null_small<N, G, R><<<blocks, kThreads, 0, stream>>>(A, batch, M, V);
}

template <int N>
int null_vectors(const float* A, int batch, int M, float* scratch, long long floats, float* V,
                 cudaStream_t stream) {
  if (M < N) {
    null_wide<N><<<(unsigned)((batch + 31) / 32), 32, 0, stream>>>(A, batch, M, V);
    return 0;
  }
  if (M <= kMaxRows) {
    // a group holds M rows: Group<N>'s when they cover M, else one a lane
    if (M <= Group<N>::G * Group<N>::R) {
      launch_small<N, Group<N>::G, Group<N>::R>(A, batch, M, V, stream);
    } else if (M <= 16) {
      launch_small<N, 16, 1>(A, batch, M, V, stream);
    } else {
      launch_small<N, 32, 1>(A, batch, M, V, stream);
    }
    return 0;
  }
  if (M <= kOneBlock) {  // one block a matrix: no stacked R's, no counter
    null_tall<N, kTallThreads, kRowsOne>
        <<<(unsigned)batch, kTallThreads, 0, stream>>>(A, M, 1, nullptr, nullptr, nullptr, V);
    return 0;
  }
  const int nblk = (M + kChunkRows - 1) / kChunkRows;
  const long long rs = (long long)batch * nblk * N * N;
  if (rs + (long long)batch * nblk + batch > floats) return (int)cudaErrorInvalidValue;
  int* exps = reinterpret_cast<int*>(scratch + rs);
  int* tickets = exps + (long long)batch * nblk;
  const cudaError_t rc = cudaMemsetAsync(tickets, 0, sizeof(int) * batch, stream);
  if (rc != cudaSuccess) return (int)rc;
  null_tall<N, kTallThreads, kRowsPerThread>
      <<<(unsigned)((long long)batch * nblk), kTallThreads, 0, stream>>>(A, M, nblk, scratch,
                                                                         exps, tickets, V);
  return 0;
}

}  // namespace

// A (batch, M, N) f32 row-major. full = 1 (M = N = 3): U, S, Vh of every
// matrix. full = 0 (N = 4, 9 or 12, any M): V (batch, N), the unit null
// vector of every matrix; a matrix of more than kOneBlock rows needs
// `floats` floats of scratch: batch * ceil(M / kChunkRows) * N * N for the
// blocks' R's, as many ints for their scale exponents, then batch ints of
// counters (ops/small_svd.py sizes it).
extern "C" int sfm_small_svd(const float* A, int batch, int M, int N, int full, float* scratch,
                             long long floats, float* U, float* S, float* V,
                             cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (full) {
    if (M != 3 || N != 3) return (int)cudaErrorInvalidValue;
    svd3<<<(unsigned)((batch + 127) / 128), 128, 0, stream>>>(A, batch, U, S, V);
    return (int)cudaGetLastError();
  }
  int rc;
  switch (N) {
    case 4: rc = null_vectors<4>(A, batch, M, scratch, floats, V, stream); break;
    case 9: rc = null_vectors<9>(A, batch, M, scratch, floats, V, stream); break;
    case 12: rc = null_vectors<12>(A, batch, M, scratch, floats, V, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return rc ? rc : (int)cudaGetLastError();
}
