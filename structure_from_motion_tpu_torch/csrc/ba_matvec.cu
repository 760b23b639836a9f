// B5 / B6: the camera halves of the reduced-camera PCG matvec; B8: the
// block-Jacobi preconditioner's diagonal blocks over the same camera view.
//
// Replaces the TPU kernels structure_from_motion_tpu/ops/ba_matvec_pallas.py
// pallas_expand_cam (_expand_kernel) and pallas_reduce_cam (_reduce_kernel).
// Both run once per CG iteration of the whole-trajectory global bundle
// adjustment, over the whole observation stream:
//
//   B5 expand:  t_o    = W_o^T x[cam_o]                 (O, 3)
//   B6 reduce:  coup_v = sum_{o: cam_o = v} W_o y_o     (V, 7)
//
// W is B4's row-major (O, 21) output (component i*3+c of the 7x3 block).
// Both kernels are templated on the camera block's width NC: 7 for [C, q],
// 10 for the self-calibrating [C, q, f, k1, k2] (W then (O, 30), x (V, 10));
// the instantiations are expand_cam_kernel<7>/<10> and reduce_cam_kernel<7,
// ..>/<10, ..> (the second parameter: camera tiers, below), and the width-10
// ones read 120 bytes of W a slot, not 84. B6's 30 components still fit one
// warp a row.
//
// What bounds them on an H100: device-memory traffic and gather latency.
// Each observation moves 84 bytes of W plus 12 to 28 bytes of vectors for
// 21 multiply-adds; there is nothing for the tensor cores to do. The TPU
// kernels built a one-hot (slots x V) tile in VMEM and contracted it on the
// MXU, because row gathers are slow there; on Hopper a gather is an ordinary
// load, so the one-hot (V times the work) is not copied.
//
// B5 design: one thread per observation reads cam_o, the 7 values of
// x[cam_o] (through the read-only cache; x is 14 KB at V = 500, so it stays
// in L1/L2) and W_o, and writes its 3 outputs. Neighbouring threads read
// neighbouring W rows. No limit on V.
//
// B6 design: the output must be the same bits on every run, so there are no
// float atomics; it is a segment sum over the camera-major view of the stream
// that the BA call builds once (ops/ba.compute_cam_ell: perm[v * rows + r] is
// camera v's r-th observation, mask marks filled slots). What bounds it is
// neither its 16 MB (4.9 us at the 500-camera shape) nor arithmetic but how
// the W rows are asked for: an 84-byte row at a 4-byte alignment, one row per
// slot at an address only perm knows.
//
// * One block a camera (512 threads), so 500 cameras fill the card; warp w
//   takes the 32-slot chunks w, w + 16, ... of the camera's rows.
// * A chunk's mask and perm are read by the 32 lanes at once (one coalesced
//   request each, neither waiting for the other), and the next chunk's are
//   requested before this chunk's rows. A chunk with no filled slot ends at
//   the ballot without touching W.
// * The warp then reads W ROW BY ROW: lanes 0..20 take the 21 components of
//   one row, so a row's three or four 32-byte sectors are one request, and
//   lane i*3+c reads y[3 o + c] beside it. 16 rows' loads are issued before
//   the first multiply.
// * Fixed order: lane i*3+c sums W[i][c] y[c] over its warp's slots in slot
//   order; at the end z_i = (c0 + c1) + c2 by two shuffles, and thread i adds
//   the warps' z_i from shared memory in warp order. The order depends on
//   rows and the block size only, never on timing.
// * No limit on V or rows. 32 registers, 448 bytes of shared memory.
// * Camera tiers: where one row count for every camera would pad the view
//   past twice the observations (a photo collection's popular cameras),
//   the BA call cuts the cameras into tiers of their own row counts
//   (ops/ba.compute_cam_tiers), and seg (V, 2) gives camera v's first slot
//   and rows (the kSeg instantiations); the walk and its order within a
//   camera are those of one row count.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (500 cameras x 432 slots,
// 159,035 filled; device time under torch.profiler, tools/profile_kernels.py,
// both versions in one run): the first port's kernel (one warp a camera,
// each lane walking its slots one after another with 21 strided scalar loads
// a row) 15.8 us -> 7.2 us, 68% of the bound; after 64 MB of other traffic
// 37 -> 16.5 us by events. Tried and set aside (tools/kernel_variants.py,
// device time, 7.2 us for the tree's kernel in that run): 256 threads a
// camera 7.8 us, 128 threads 9.4, 1024 threads 8.8; 8 rows in flight 7.6, 32
// rows 7.1; one slot a thread with scalar loads
// (tools/variant_sources/reduce_slot_per_thread.cu), 128 or 256 threads a
// camera and 2 or 4 slots in flight, 9.5-9.9 us.

// B8 cam_diag: S_v = sum over camera v's filled view slots o of
// W_o D^-1_{p(o)} W_o^T, the exact NC x NC diagonal blocks of the Schur
// complement that the PCG's block-Jacobi preconditioner inverts, once per LM
// iteration. It replaces no Pallas kernel: in the JAX package XLA fused
// this einsum (structure_from_motion_tpu/ops/ba.py:549-555). Unfused on
// the card it wrote a (O, NC, 3) and a (O, NC, NC) product per slot, then
// gathered and masked the latter through the camera view: ~20 GB of traffic
// an LM iteration at BAL Venice for 1778 blocks of 10 x 10.
//
// What bounds it: device memory. A filled slot reads its W row (84 or 120
// bytes), its point id (4) and its point's 36-byte D^-1 (35.8 MB for all of
// Venice's points: mostly L2 hits); a view slot its perm and mask (5 bytes).
// ~0.66 GB a launch at Venice, 0.20 ms at 3.35 TB/s; the ~510 flops a slot
// (the NC x 3 product W D^-1, then 55 dot products of 3) are far below the
// compute bound. No per-slot product goes to device memory.
//
// * B6's walk, cut into parts: a camera's run is read in rounds of 256
//   slots (warp w of a block takes the round's 32-slot chunk w), and block
//   (v, j) of a (V, parts) grid takes camera v's rounds j, j + parts, ...
//   (slot_observation; the next round's perm and mask requested before this
//   one's rows); seg or one row count as B6 (the kSeg instantiations); a
//   chunk with no filled slot ends at the ballot. With one block a camera
//   (call 1), Venice's busiest camera (45,456 slots, 16x the mean) alone
//   took most of the launch; parts = the mean run over 512 slots, rounded
//   up (1 at the 500-camera solve, 8 at Venice), set from the view's
//   length and V.
// * A chunk's 32 W rows and 32 D^-1 blocks are read flat, element e =
//   k * 32 + lane of the chunk's (32, 3 NC) and (32, 9) blocks (a few rows a
//   request, the point ids first), into the warp's shared memory at an odd
//   row stride; then each lane takes ITS slot's row and block from there
//   without bank conflicts.
// * Each lane keeps the NC (NC + 1) / 2 upper-triangle sums of its slots in
//   registers: row i of W D^-1 (3 values) is formed, then its dot products
//   with rows j >= i of W are added. At the end a xor butterfly sums the
//   lanes and thread t adds the warps' sums in warp order: entry t of the
//   block and its mirror where parts = 1, else entry t of part j, which
//   cam_diag_fold adds in part order. The order depends on rows, parts and
//   the block size only: the same bits on every run, no float atomics.
// * 256 threads and at most 128 registers (2 blocks an SM); 42 KB of static
//   shared memory at NC = 10.

#include <cuda_runtime.h>

namespace {

constexpr int kExpandThreads = 256;
constexpr int kReduceThreads = 512;  // B6: one block a camera
constexpr int kReduceWarps = kReduceThreads / 32;
constexpr int kReduceBatch = 16;  // rows of one warp whose loads are in flight together
constexpr unsigned kReduceBatchMask = (1u << kReduceBatch) - 1u;
constexpr int kDiagThreads = 256;  // B8: one block a camera
constexpr int kDiagWarps = kDiagThreads / 32;

template <int NC>
__global__ void __launch_bounds__(kExpandThreads)
expand_cam_kernel(const int* __restrict__ cam, const float* __restrict__ w21,
                  const float* __restrict__ x, int O, int V,
                  float* __restrict__ t) {
  constexpr int kW = 3 * NC;  // a slot's W row: 21 or 30 floats
  const int o = blockIdx.x * kExpandThreads + threadIdx.x;
  if (o >= O) return;
  const int v = cam[o];
  float xo[NC];
  if (v >= 0 && v < V) {
#pragma unroll
    for (int i = 0; i < NC; ++i) xo[i] = __ldg(x + NC * v + i);
  } else {
#pragma unroll
    for (int i = 0; i < NC; ++i) xo[i] = 0.f;
  }
  const float* w = w21 + (size_t)o * kW;
  float wr[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) wr[k] = w[k];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = wr[c] * xo[0];
#pragma unroll
    for (int i = 1; i < NC; ++i) acc += wr[3 * i + c] * xo[i];
    t[(size_t)o * 3 + c] = acc;
  }
}

// The r-th slot of camera-major row `base`: its observation, or -1 where the
// slot is beyond `rows`, unfilled, or names no observation. mask and perm are
// read together (neither waits for the other).
__device__ __forceinline__ int slot_observation(const int* __restrict__ perm,
                                                const unsigned char* __restrict__ mask,
                                                size_t base, int r, int rows, int O) {
  if (r >= rows) return -1;
  const unsigned char m = mask[base + r];
  const int o = perm[base + r];
  return (m && o < O) ? o : -1;
}

// kSeg: camera v's slots are its own run of the view, seg[v] = (first
// slot, rows), in place of [v * rows, (v + 1) * rows)
template <int NC, bool kSeg>
__global__ void __launch_bounds__(kReduceThreads)
reduce_cam_kernel(const float* __restrict__ w21, const float* __restrict__ y,
                  const int* __restrict__ perm,
                  const unsigned char* __restrict__ mask,
                  const int* __restrict__ seg, int O, int rows_,
                  float* __restrict__ coup) {
  constexpr int kW = 3 * NC;  // a slot's W row: 21 or 30 floats
  __shared__ float part[kReduceWarps][NC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = blockIdx.x;
  const int rows = kSeg ? seg[2 * v + 1] : rows_;
  const size_t base = kSeg ? (size_t)seg[2 * v] : (size_t)v * rows;
  const bool comp = lane < kW;  // lane i*3+c owns component (i, c) of W
  const int c = lane % 3;
  float acc = 0.f;
  // warp w takes the 32-slot chunks w, w + kReduceWarps, ..: one slot a lane,
  // the next chunk's slots requested before this chunk's rows
  int r = warp * 32 + lane;
  int o = slot_observation(perm, mask, base, r, rows, O);
  while (r - lane < rows) {  // warp-uniform
    r += kReduceThreads;
    const int o_next = slot_observation(perm, mask, base, r, rows, O);
    const unsigned filled = __ballot_sync(0xffffffffu, o >= 0);
#pragma unroll
    for (int b = 0; b < 32; b += kReduceBatch) {
      if (((filled >> b) & kReduceBatchMask) == 0) continue;  // warp-uniform
      float wv[kReduceBatch], yv[kReduceBatch];
#pragma unroll
      for (int k = 0; k < kReduceBatch; ++k) {  // every load of the batch first
        const int ok = __shfl_sync(0xffffffffu, o, b + k);
        const bool on = comp && ok >= 0;
        wv[k] = on ? w21[(size_t)ok * kW + lane] : 0.f;
        yv[k] = on ? y[(size_t)ok * 3 + c] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kReduceBatch; ++k) acc = fmaf(wv[k], yv[k], acc);  // slot order
    }
    o = o_next;
  }
  // component sums -> z_i = (c0 + c1) + c2 on lane 3i, then the warps in order
  const float z = (acc + __shfl_down_sync(0xffffffffu, acc, 1)) +
                  __shfl_down_sync(0xffffffffu, acc, 2);
  if (comp && c == 0) part[warp][lane / 3] = z;
  __syncthreads();
  if (threadIdx.x < NC) {
    float sum = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kReduceWarps; ++w) sum += part[w][threadIdx.x];
    coup[NC * (size_t)v + threadIdx.x] = sum;
  }
}

// Entry t of the upper triangle of an nc x nc block, row by row -> (i, j).
__device__ __forceinline__ void upper_entry(int t, int nc, int& i, int& j) {
  i = 0;
  while (t >= nc - i) t -= nc - i++;
  j = i + t;
}

// B8 (see the note at the top): kSeg as B6's. w (O, 3 NC), dinv (M, 9) f32,
// point (O,) int32 -> out (V, NC, NC) f32 where parts = 1, else part_out
// (V, parts, NC (NC + 1) / 2) f32, the parts' upper triangles.
template <int NC, bool kSeg>
__global__ void __launch_bounds__(kDiagThreads, 2)
cam_diag_kernel(const float* __restrict__ w, const float* __restrict__ dinv,
                const int* __restrict__ point, const int* __restrict__ perm,
                const unsigned char* __restrict__ mask, const int* __restrict__ seg,
                int O, int M, int rows_, int parts, float* __restrict__ part_out,
                float* __restrict__ out) {
  constexpr int kW = 3 * NC;  // a slot's W row: 21 or 30 floats
  constexpr int kWs = kW | 1;  // its stride in shared memory: odd, so no bank conflicts
  constexpr int kT = NC * (NC + 1) / 2;  // the upper triangle of a block
  __shared__ float sw[kDiagWarps][32 * kWs];
  __shared__ float sd[kDiagWarps][32 * 9];
  __shared__ float warp_sums[kDiagWarps][kT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = blockIdx.x, part = blockIdx.y;
  const int rows = kSeg ? seg[2 * v + 1] : rows_;
  const size_t base = kSeg ? (size_t)seg[2 * v] : (size_t)v * rows;
  if (part * kDiagThreads >= rows) {  // block-uniform: no round of this part
    if (parts == 1)
      for (int t = threadIdx.x; t < NC * NC; t += kDiagThreads) out[(size_t)v * NC * NC + t] = 0.f;
    return;  // cam_diag_fold reads no such part
  }
  float* const myw = sw[warp];
  float* const myd = sd[warp];
  float acc[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) acc[t] = 0.f;
  int round = part;
  int o = slot_observation(perm, mask, base, round * kDiagThreads + warp * 32 + lane, rows, O);
  while (round * kDiagThreads < rows) {  // block-uniform
    round += parts;
    const int o_next =
        slot_observation(perm, mask, base, round * kDiagThreads + warp * 32 + lane, rows, O);
    if (__ballot_sync(0xffffffffu, o >= 0)) {  // warp-uniform
      int p = o >= 0 ? point[o] : -1;
      if (p >= M) p = -1;
      float wv[kW], dv[9];
#pragma unroll
      for (int k = 0; k < kW; ++k) {  // element k * 32 + lane of the chunk's W rows
        const int e = k * 32 + lane, row = e / kW;
        const int ok = __shfl_sync(0xffffffffu, o, row);
        wv[k] = ok >= 0 ? w[(size_t)ok * kW + (e - row * kW)] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {  // element k * 32 + lane of the chunk's D^-1 blocks
        const int e = k * 32 + lane, row = e / 9;
        const int pk = __shfl_sync(0xffffffffu, p, row);
        dv[k] = pk >= 0 ? dinv[(size_t)pk * 9 + (e - row * 9)] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        const int e = k * 32 + lane, row = e / kW;
        myw[row * kWs + (e - row * kW)] = wv[k];
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) myd[k * 32 + lane] = dv[k];
      __syncwarp();
      // this lane's slot: its row of W and its D^-1 (zero for an empty slot)
      float wr[kW], d[9];
#pragma unroll
      for (int k = 0; k < kW; ++k) wr[k] = myw[lane * kWs + k];
#pragma unroll
      for (int k = 0; k < 9; ++k) d[k] = myd[lane * 9 + k];
      int t = 0;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        // row i of W D^-1
        const float a0 = fmaf(wr[3 * i + 2], d[6], fmaf(wr[3 * i + 1], d[3], wr[3 * i] * d[0]));
        const float a1 = fmaf(wr[3 * i + 2], d[7], fmaf(wr[3 * i + 1], d[4], wr[3 * i] * d[1]));
        const float a2 = fmaf(wr[3 * i + 2], d[8], fmaf(wr[3 * i + 1], d[5], wr[3 * i] * d[2]));
#pragma unroll
        for (int j = i; j < NC; ++j, ++t)
          acc[t] = fmaf(a2, wr[3 * j + 2], fmaf(a1, wr[3 * j + 1], fmaf(a0, wr[3 * j], acc[t])));
      }
      __syncwarp();  // the next chunk overwrites this one's rows
    }
    o = o_next;
  }
  // the lanes' sums (a xor butterfly: every lane ends with the same bits),
  // then the warps' in warp order
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    float s = acc[t];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    acc[t] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kT; ++t) warp_sums[warp][t] = acc[t];
  }
  __syncthreads();
  if (threadIdx.x < kT) {
    const int t = threadIdx.x;
    float sum = warp_sums[0][t];
#pragma unroll
    for (int ww = 1; ww < kDiagWarps; ++ww) sum += warp_sums[ww][t];
    if (parts == 1) {
      int i, j;
      upper_entry(t, NC, i, j);
      float* const blk = out + (size_t)v * NC * NC;
      blk[i * NC + j] = sum;
      blk[j * NC + i] = sum;
    } else {
      part_out[((size_t)v * parts + part) * kT + t] = sum;
    }
  }
}

// B8's second launch where parts > 1: out[v] = the sum of camera v's parts
// that have a round, in part order, with its mirror. One block a camera.
__global__ void __launch_bounds__(64)
cam_diag_fold(const float* __restrict__ part_out, const int* __restrict__ seg, int rows_,
              int parts, int nc, float* __restrict__ out) {
  const int v = blockIdx.x, t = threadIdx.x, n_t = nc * (nc + 1) / 2;
  if (t >= n_t) return;
  const int rows = seg != nullptr ? seg[2 * v + 1] : rows_;
  const int n = min(parts, (rows + kDiagThreads - 1) / kDiagThreads);
  float sum = 0.f;
  for (int p = 0; p < n; ++p) sum += part_out[((size_t)v * parts + p) * n_t + t];
  int i, j;
  upper_entry(t, nc, i, j);
  out[((size_t)v * nc + i) * nc + j] = sum;
  out[((size_t)v * nc + j) * nc + i] = sum;
}

}  // namespace

// cam (O,) int32, w (O, 3 * nc), x (V, nc) f32 -> t (O, 3) f32, for a camera
// block of nc = 7 or 10 entries. A camera id outside [0, V) gives a zero row.
extern "C" int sfm_expand_cam_w(const int* cam, const float* w, const float* x,
                                int O, int V, int nc, float* t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (O + kExpandThreads - 1) / kExpandThreads;
  if (nc != 7 && nc != 10) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0) {
    if (nc == 7)
      expand_cam_kernel<7><<<nb, kExpandThreads, 0, s>>>(cam, w, x, O, V, t);
    else
      expand_cam_kernel<10><<<nb, kExpandThreads, 0, s>>>(cam, w, x, O, V, t);
  }
  return static_cast<int>(cudaGetLastError());
}

// w (O, 3 * nc), y (O, 3) f32; perm and mask (S,), the camera-major view of
// the stream -> coup (V, nc) f32. Camera v's slots are [v * rows, (v + 1) *
// rows) of the view, or, with seg (V, 2) int32, the seg[v][1] slots from
// seg[v][0] (the camera tiers: rows differ from tier to tier).
extern "C" int sfm_reduce_cam_w(const float* w, const float* y, const int* perm,
                                const unsigned char* mask, const int* seg, int O,
                                int V, int rows, int nc, float* coup, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc != 7 && nc != 10) return static_cast<int>(cudaErrorInvalidValue);
  if (V > 0) {
    const dim3 g(V), b(kReduceThreads);
    if (nc == 7 && seg == nullptr)
      reduce_cam_kernel<7, false><<<g, b, 0, s>>>(w, y, perm, mask, seg, O, rows, coup);
    else if (nc == 7)
      reduce_cam_kernel<7, true><<<g, b, 0, s>>>(w, y, perm, mask, seg, O, rows, coup);
    else if (seg == nullptr)
      reduce_cam_kernel<10, false><<<g, b, 0, s>>>(w, y, perm, mask, seg, O, rows, coup);
    else
      reduce_cam_kernel<10, true><<<g, b, 0, s>>>(w, y, perm, mask, seg, O, rows, coup);
  }
  return static_cast<int>(cudaGetLastError());
}

// The [C, q] camera block: w21 (O, 21), y (O, 3) f32; perm (V * rows,) int32
// and mask (V * rows,) bool -> coup (V, 7) f32.
extern "C" int sfm_reduce_cam(const float* w21, const float* y, const int* perm,
                              const unsigned char* mask, int O, int V, int rows,
                              float* coup, void* stream) {
  return sfm_reduce_cam_w(w21, y, perm, mask, nullptr, O, V, rows, 7, coup, stream);
}

// w (O, 3 * nc) f32, dinv (M, 3, 3) f32, point (O,) int32; perm and mask (S,),
// the camera-major view, camera v's slots as in sfm_reduce_cam_w (seg or one
// row count) -> out (V, nc, nc) f32: each camera's sum of W_o D^-1_{p(o)}
// W_o^T over its filled slots, its run read by `parts` blocks; part_out
// (V, parts, nc (nc + 1) / 2) f32 scratch where parts > 1. A point id
// outside [0, M) reads a zero block.
extern "C" int sfm_cam_diag_w(const float* w, const float* dinv, const int* point,
                              const int* perm, const unsigned char* mask, const int* seg,
                              int O, int M, int V, int rows, int nc, int parts,
                              float* part_out, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((nc != 7 && nc != 10) || parts < 1 || (parts > 1 && part_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (V > 0) {
    const dim3 g(V, parts), b(kDiagThreads);
    if (nc == 7 && seg == nullptr)
      cam_diag_kernel<7, false><<<g, b, 0, s>>>(w, dinv, point, perm, mask, seg, O, M, rows,
                                                parts, part_out, out);
    else if (nc == 7)
      cam_diag_kernel<7, true><<<g, b, 0, s>>>(w, dinv, point, perm, mask, seg, O, M, rows,
                                               parts, part_out, out);
    else if (seg == nullptr)
      cam_diag_kernel<10, false><<<g, b, 0, s>>>(w, dinv, point, perm, mask, seg, O, M, rows,
                                                 parts, part_out, out);
    else
      cam_diag_kernel<10, true><<<g, b, 0, s>>>(w, dinv, point, perm, mask, seg, O, M, rows,
                                                parts, part_out, out);
    if (parts > 1) {
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      cam_diag_fold<<<V, 64, 0, s>>>(part_out, seg, rows, parts, nc, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
