// B3: fused L2 distance + running top-2 nearest-neighbour search.
//
// Replaces the TPU kernel structure_from_motion_tpu/ops/matching.py
// (pallas_match_top2: _match_top2_kernel). For every reference row it finds,
// over the VALID query rows, the smallest and second-smallest partial squared
// distance  |q_j|^2 - 2 r.q_j  and the index of the smallest (the lowest
// index on ties, lax.top_k's rule). The caller adds |r|^2 afterwards; the
// (Nr, Nq) distance matrix never reaches device memory.
//
// What bounds it on an H100: arithmetic. Nr x Nq x 128 multiply-adds (17.2
// GFLOP at the slice's 32768 x 2048) against 17 MB of input, ~1000 FLOP a
// byte. On the CUDA cores' f32 pipe (67 TFLOP/s) that is 0.26 ms; on the
// tensor cores, as three TF32 products (51.5 GFLOP at 495 TFLOP/s), 0.10 ms.
//
// What the design does:
//
// * The product runs on the tensor cores (wgmma m64n64k8, TF32 in, f32
//   accumulate) at f32-level accuracy. One-pass TF32 (10 mantissa bits) would
//   move the ratio test, so every f32 operand is split into a TF32 head and
//   the exact f32 rest, x = hi + lo, and three products accumulate in f32:
//   lo x hi + hi x lo + hi x hi (the lo x lo term is below f32 rounding). The
//   head is the word with its low 13 mantissa bits cleared, which is what the
//   tensor core reads of a raw f32 word anyway; the rest is one subtraction.
// * The references are the A operand and live in REGISTERS: a 256-thread
//   block (two warpgroups) owns 128 reference rows, a warp 16 of them, and a
//   thread loads its fragments of all 16 k-steps once, splits them once, and
//   keeps the 128 words for the whole block. The main loop has no shared
//   load and no split for A.
// * The queries are the B operand, streamed (1 MB, L2-resident) in 64-row
//   tiles by cp.async into a ring of four stages, straight into the K-major
//   128-byte-swizzled layout wgmma's descriptors read (16-byte chunk c of row
//   n at chunk c ^ (n & 7)); the raw tile IS the head operand. The rests of
//   tile i + 1 are made on the SM (one pass over shared memory into a ring of
//   two) while the 48 products of tile i run. Tiles are requested two tiles
//   ahead; one __syncthreads a tile, with the proxy fence wgmma needs to see
//   writes made by ordinary stores.
// * Top-2 epilogue in registers: a reference row belongs to one warp, and
//   each of its 4 threads sees a quarter of all queries for rows g and g + 8,
//   in ascending order, so a thread carries two (d1, d2, j1) states. The
//   update is branch-free (two min/max and a select); masked queries enter as
//   3e38 and change nothing, which keeps the TPU kernel's sentinel: with
//   fewer than two valid queries d2 (and d1) stay 3e38 and j1 stays 0. At the
//   end the 4 threads of a row merge by shuffles ordered by (d1, j1): ties go
//   to the lowest index and nothing depends on timing, so two launches give
//   the same bits. There is no merge across warps.
// * 256 blocks at the slice's shape on 132 SMs (one block an SM: 193 KB of
//   shared memory, 221 registers a thread): two waves, the second 94% full.
//
// Tried on the card and set aside (NVIDIA H100 80GB HBM3, 700 W; device time
// of this kernel at 32768 x 2048 x 128 under torch.profiler, by
// tools/profile_kernels.py, variants compared within one run): the first
// port's f32 FMA kernel 930 us; mma.sync.m16n8k8 TF32 with the same split,
// 16 warps, 32 x 32 warp tiles, 309-312 us (cvt.rna.tf32 for the split instead
// of the mask: 348 us); wgmma with the queries as A from shared memory and
// the references as B, 220 us (its 16 states a thread make the fold the
// largest item); this design with the queries' rests read from a second
// global tensor instead of made on the SM, 237 us (twice the L2 traffic);
// with a branching fold 238 us, with the branch-free one 177 us; folding
// tile i while tile i + 1 multiplies into a second accumulator set made
// ptxas serialise the products (C7514), 280 us.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kD = 128;
constexpr int kTR = 128;   // reference rows per block: two warpgroups x m64
constexpr int kTQ = 64;    // query rows per tile: the n of one wgmma
constexpr int kStages = 4;    // ring of query tiles as they arrive (the heads)
constexpr int kLoStages = 2;  // their rests, made on the SM one tile ahead
constexpr int kThreads = 256;
constexpr float kInf = 3.0e38f;
constexpr int kNoIndex = 0x7fffffff;
constexpr int kAtomBytes = kTQ * 128;             // a 32-entry slice of all tile rows
constexpr int kTileBytes = (kD / 32) * kAtomBytes;  // 32 KB: head or rest of a tile
constexpr int kLoBase = kStages * kTileBytes;
constexpr int kQnBase = kLoBase + kLoStages * kTileBytes;
constexpr size_t kSmemBytes = 1024 + kQnBase + kStages * kTQ * 4;

struct Top2 {
  float d1, d2;
  int j1;
};

// Candidate (d, j) into a running top-2, branch-free: a tie keeps the
// earlier candidate; d = kInf changes nothing.
__device__ __forceinline__ void push(Top2& t, float d, int j) {
  t.d2 = fminf(t.d2, fmaxf(t.d1, d));
  t.j1 = d < t.d1 ? j : t.j1;
  t.d1 = fminf(t.d1, d);
}

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_wins = (a.d1 < b.d1) || (a.d1 == b.d1 && a.j1 < b.j1);
  Top2 w = a_wins ? a : b;
  const Top2& l = a_wins ? b : a;
  w.d2 = fminf(w.d2, l.d1);
  return w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo: hi keeps the 10 mantissa bits TF32 has; lo is the exact f32
// rest, of which the tensor core reads the leading 10 bits
__device__ __forceinline__ float tf32_head(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// 16 bytes global -> shared; zero-fills when !ok (src must still be valid)
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool ok) {
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// byte offset of 16-byte chunk c32 (0..31 along the descriptor) of tile row n
// in the K-major 128-byte-swizzled layout wgmma reads
__device__ __forceinline__ int tile_offset(int n, int c32) {
  return (c32 >> 3) * kAtomBytes + n * 128 + (((c32 & 7) ^ (n & 7)) << 4);
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, f32, 32 registers a thread) (+)= A (64 x 8, registers) x B (8 x 64, shared)
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// keeps the compiler from moving accumulator reads across the asynchronous
// products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kThreads, 1)
match_top2(const float* __restrict__ ref, const float* __restrict__ que,
           const float* __restrict__ sqq, const unsigned char* __restrict__ maskq,
           int Nr, int Nq,
           float* __restrict__ d1_out, float* __restrict__ d2_out,
           int* __restrict__ j1_out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  float* qn = reinterpret_cast<float*>(sm + kQnBase);  // kStages x [kTQ]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kTR;
  const int ntiles = (Nq + kTQ - 1) / kTQ;

  auto load_tile = [&](int it) {
    const int stage = it % kStages, q0 = it * kTQ;
    const uint32_t dst = base + stage * kTileBytes;
#pragma unroll
    for (int i = 0; i < (kTQ * 32) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int n = idx >> 5, c32 = idx & 31;
      const bool ok = q0 + n < Nq;
      cp_async16(dst + tile_offset(n, c32), que + (size_t)(ok ? q0 + n : 0) * kD + 4 * c32, ok);
    }
    if (tid < kTQ) {
      const int j = q0 + tid;
      qn[stage * kTQ + tid] = (j < Nq && maskq[j]) ? sqq[j] : kInf;
    }
  };
  // the rests of tile it, from its heads (the raw f32 words) in shared memory
  auto make_rest = [&](int it) {
    const unsigned char* hi = sm + (it % kStages) * kTileBytes;
    unsigned char* lo = sm + kLoBase + (it % kLoStages) * kTileBytes;
#pragma unroll
    for (int i = 0; i < (kTQ * 32) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int off = tile_offset(idx >> 5, idx & 31);
      const float4 v = *reinterpret_cast<const float4*>(hi + off);
      *reinterpret_cast<float4*>(lo + off) =
          make_float4(v.x - tf32_head(v.x), v.y - tf32_head(v.y), v.z - tf32_head(v.z),
                      v.w - tf32_head(v.w));
    }
  };
#pragma unroll
  for (int it = 0; it < 3; ++it) {  // one group a tile, empty past the end
    if (it < ntiles) load_tile(it);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // This thread's fragments of its warp's 16 reference rows, head and rest,
  // for all 16 k-steps: rows row_a (g) and row_a + 8, entries 8 ks + t and
  // 8 ks + t + 4. They stay in registers for the whole block.
  const int row_a = r0 + warp * 16 + g;
  uint32_t ahi[kD / 8][4], alo[kD / 8][4];
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row_a + (i & 1) * 8;
      const float x = row < Nr ? __ldg(ref + (size_t)row * kD + ks * 8 + t + (i >> 1) * 4) : 0.f;
      const float hi = tf32_head(x);
      ahi[ks][i] = __float_as_uint(hi);
      alo[ks][i] = __float_as_uint(x - hi);
    }

  // all 48 products of a tile: rest x head + head x rest + head x head
  auto multiply_tile = [&](float (&acc)[32], int it) {
    const uint64_t d_hi = make_desc(base + (it % kStages) * kTileBytes);
    const uint64_t d_lo = make_desc(base + kLoBase + (it % kLoStages) * kTileBytes);
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) {
      const uint64_t koff = (uint64_t)(((ks >> 2) * kAtomBytes + (ks & 3) * 32) >> 4);
      wgmma_m64n64k8(acc, alo[ks], d_hi + koff, ks > 0);
      wgmma_m64n64k8(acc, ahi[ks], d_lo + koff, 1);
      wgmma_m64n64k8(acc, ahi[ks], d_hi + koff, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  Top2 st[2] = {Top2{kInf, kInf, kNoIndex}, Top2{kInf, kInf, kNoIndex}};  // rows g, g + 8
  // this thread's 16 queries of the tile, in ascending order, into its two
  // rows; a masked query enters as kInf
  auto fold = [&](float (&acc)[32], int it) {
    fence_regs(acc);
    const float* qnt = qn + (it % kStages) * kTQ + 2 * t;
    float qv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(qnt + 8 * j);
      qv[2 * j] = v.x;
      qv[2 * j + 1] = v.y;
    }
    const int j0 = it * kTQ + 2 * t;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const bool on = qv[c] < kInf;
      const int j = j0 + 8 * (c >> 1) + (c & 1);
      push(st[0], on ? qv[c] - 2.f * acc[4 * (c >> 1) + (c & 1)] : kInf, j);
      push(st[1], on ? qv[c] - 2.f * acc[4 * (c >> 1) + 2 + (c & 1)] : kInf, j);
    }
  };

  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  __syncthreads();
  make_rest(0);
  float acc[32];
  for (int it = 0; it < ntiles; ++it) {
    // tiles it and it + 1 have landed (it + 2 may be on its way); the rests
    // of tile it are written: publish both to the tensor cores' proxy
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // and tile it - 1 is consumed by all: its stages are free
    if (it + 3 < ntiles) load_tile(it + 3);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    multiply_tile(acc, it);
    if (it + 1 < ntiles) make_rest(it + 1);  // while the products run
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fold(acc, it);
  }

  // the 4 threads that share a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      Top2 o;
      o.d1 = __shfl_xor_sync(0xffffffffu, st[r].d1, off);
      o.d2 = __shfl_xor_sync(0xffffffffu, st[r].d2, off);
      o.j1 = __shfl_xor_sync(0xffffffffu, st[r].j1, off);
      st[r] = merge(st[r], o);
    }
    const int row = row_a + 8 * r;
    if (t == 0 && row < Nr) {
      d1_out[row] = st[r].d1;
      d2_out[row] = st[r].d2;
      j1_out[row] = st[r].j1 == kNoIndex ? 0 : st[r].j1;
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
  match_top2<<<grid, kThreads, kSmemBytes, s>>>(ref, que, sqq, mask_que, Nr, Nq,
                                                d1, d2, j1);
  return static_cast<int>(cudaGetLastError());
}
