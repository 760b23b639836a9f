// B5 / B6: the camera halves of the reduced-camera PCG matvec.
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

#include <cuda_runtime.h>

namespace {

constexpr int kExpandThreads = 256;
constexpr int kReduceThreads = 512;  // B6: one block a camera
constexpr int kReduceWarps = kReduceThreads / 32;
constexpr int kReduceBatch = 16;  // rows of one warp whose loads are in flight together
constexpr unsigned kReduceBatchMask = (1u << kReduceBatch) - 1u;

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
