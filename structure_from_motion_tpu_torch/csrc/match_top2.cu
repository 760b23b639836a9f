// B3: fused L2 distance + running top-2 nearest-neighbour search.
//
// Replaces the TPU kernel structure_from_motion_tpu/ops/matching.py
// (pallas_match_top2: _match_top2_kernel). For every reference row it finds,
// over the VALID query rows, the smallest and second-smallest partial squared
// distance  |q_j|^2 - 2 r.q_j  and the index of the smallest (the lowest
// index on ties, lax.top_k's rule). The caller adds |r|^2 afterwards; the
// (Nr, Nq) distance matrix never reaches device memory.
//
// What bounds it on an H100: f32 arithmetic. Nr x Nq x 128 FMAs (8.6 G at the
// slice's 32768 x 2048) against a few MB of input: ~500 FLOP/byte, so the
// CUDA cores' f32 FMA rate is the limit. Tensor cores (TF32/bf16) would change
// the numbers the ratio test sees and are a later decision.
//
// What the design does about it: a 256-thread block owns 64 reference rows
// and streams the queries through shared memory in 64-row tiles, both stored
// k-major so each thread's inner loop is two 16-byte shared loads feeding a
// 4x4 register tile of 16 FMAs (the classic SGEMM micro-kernel, 4 FMAs per
// load). Each thread keeps a running (d1, d2, j1) for its 4 rows over the
// queries it owns, in ascending query order; the 16 threads of a row group
// then merge with warp shuffles. The merge orders by (d1, j1), so the result
// does not depend on the order threads finish. Masked queries never enter
// the running state, which reproduces the TPU kernel's 3e38 sentinel: with
// fewer than two valid queries d2 (and d1) stay 3e38 and j1 stays 0.

#include <cuda_runtime.h>

namespace {

constexpr int kD = 128;
constexpr int kTR = 64;
constexpr int kTQ = 64;
constexpr int kThreads = 256;
constexpr float kInf = 3.0e38f;
constexpr int kNoIndex = 0x7fffffff;
constexpr size_t kSmemBytes = sizeof(float) * kD * (kTR + kTQ);

struct Top2 {
  float d1, d2;
  int j1;
};

__device__ __forceinline__ void push(Top2& t, float d, int j) {
  if (d < t.d1) {
    t.d2 = t.d1;
    t.d1 = d;
    t.j1 = j;
  } else if (d < t.d2) {
    t.d2 = d;
  }
}

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_wins = (a.d1 < b.d1) || (a.d1 == b.d1 && a.j1 < b.j1);
  Top2 w = a_wins ? a : b;
  const Top2& l = a_wins ? b : a;
  w.d2 = fminf(w.d2, l.d1);
  return w;
}

__global__ void __launch_bounds__(kThreads)
match_top2(const float* __restrict__ ref, const float* __restrict__ que,
           const float* __restrict__ sqq, const unsigned char* __restrict__ maskq,
           int Nr, int Nq, float* __restrict__ d1_out,
           float* __restrict__ d2_out, int* __restrict__ j1_out) {
  extern __shared__ float smem[];
  float* rs = smem;             // [kD][kTR]
  float* qs = smem + kD * kTR;  // [kD][kTQ]
  __shared__ float qn[kTQ];     // |q|^2 of the tile, kInf where masked
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int r0 = blockIdx.x * kTR;

  for (int i = tid; i < kTR * (kD / 4); i += kThreads) {
    const int row = i % kTR, k4 = i / kTR;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < Nr)
      v = reinterpret_cast<const float4*>(ref + (size_t)(r0 + row) * kD)[k4];
    rs[(4 * k4 + 0) * kTR + row] = v.x;
    rs[(4 * k4 + 1) * kTR + row] = v.y;
    rs[(4 * k4 + 2) * kTR + row] = v.z;
    rs[(4 * k4 + 3) * kTR + row] = v.w;
  }

  Top2 st[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) st[r] = Top2{kInf, kInf, kNoIndex};

  for (int q0 = 0; q0 < Nq; q0 += kTQ) {
    __syncthreads();  // the previous query tile is consumed
    for (int i = tid; i < kTQ * (kD / 4); i += kThreads) {
      const int row = i % kTQ, k4 = i / kTQ;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + row < Nq)
        v = reinterpret_cast<const float4*>(que + (size_t)(q0 + row) * kD)[k4];
      qs[(4 * k4 + 0) * kTQ + row] = v.x;
      qs[(4 * k4 + 1) * kTQ + row] = v.y;
      qs[(4 * k4 + 2) * kTQ + row] = v.z;
      qs[(4 * k4 + 3) * kTQ + row] = v.w;
    }
    if (tid < kTQ) {
      const int j = q0 + tid;
      qn[tid] = (j < Nq && maskq[j]) ? sqq[j] : kInf;
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
    for (int k = 0; k < kD; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&rs[k * kTR + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&qs[k * kTQ + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float qv = qn[tx * 4 + c];
      if (qv < kInf) {
        const int j = q0 + tx * 4 + c;
#pragma unroll
        for (int r = 0; r < 4; ++r) push(st[r], qv - 2.f * acc[r][c], j);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      Top2 o;
      o.d1 = __shfl_xor_sync(0xffffffffu, st[r].d1, off);
      o.d2 = __shfl_xor_sync(0xffffffffu, st[r].d2, off);
      o.j1 = __shfl_xor_sync(0xffffffffu, st[r].j1, off);
      st[r] = merge(st[r], o);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + ty * 4 + r;
      if (row < Nr) {
        d1_out[row] = st[r].d1;
        d2_out[row] = st[r].d2;
        j1_out[row] = st[r].j1 == kNoIndex ? 0 : st[r].j1;
      }
    }
  }
}

}  // namespace

// ref (Nr, 128), que (Nq, 128), sqq (Nq,) = |q|^2, mask_que (Nq,) uint8 ->
// partial d1 (Nr,), d2 (Nr,) (without |r|^2) and j1 (Nr,) int32.
extern "C" int sfm_match_top2(const float* ref, const float* que,
                              const float* sqq, const unsigned char* mask_que,
                              int Nr, int Nq, float* d1, float* d2, int* j1,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      match_top2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Nr + kTR - 1) / kTR);
  match_top2<<<grid, kThreads, kSmemBytes, s>>>(ref, que, sqq, mask_que, Nr,
                                                Nq, d1, d2, j1);
  return static_cast<int>(cudaGetLastError());
}
