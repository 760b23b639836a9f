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
// float atomics. Of the two deterministic forms (per-block partial (V, 7)
// tables plus a fixed-order second pass, as B4 does; or a segment sum per
// camera) this is the segment sum: the BA call builds the camera-major view
// of the stream once (ops/ba.compute_cam_ell: perm[v * rows + r] is camera
// v's r-th observation, mask marks filled slots), and one warp per camera
// sums its rows slots, lane l taking slots l, l + 32, ... in order, then a
// fixed shuffle tree. The work is O(V * rows) ~ O(O) and independent of V,
// where a partial table costs O(blocks * V) and B4's per-block camera loop
// grows with V.

#include <cuda_runtime.h>

namespace {

constexpr int kExpandThreads = 256;
constexpr int kWarps = 4;  // cameras per B6 block

__global__ void __launch_bounds__(kExpandThreads)
expand_cam_kernel(const int* __restrict__ cam, const float* __restrict__ w21,
                  const float* __restrict__ x, int O, int V,
                  float* __restrict__ t) {
  const int o = blockIdx.x * kExpandThreads + threadIdx.x;
  if (o >= O) return;
  const int v = cam[o];
  float xo[7];
  if (v >= 0 && v < V) {
#pragma unroll
    for (int i = 0; i < 7; ++i) xo[i] = __ldg(x + 7 * v + i);
  } else {
#pragma unroll
    for (int i = 0; i < 7; ++i) xo[i] = 0.f;
  }
  const float* w = w21 + (size_t)o * 21;
  float wr[21];
#pragma unroll
  for (int k = 0; k < 21; ++k) wr[k] = w[k];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = wr[c] * xo[0];
#pragma unroll
    for (int i = 1; i < 7; ++i) acc += wr[3 * i + c] * xo[i];
    t[(size_t)o * 3 + c] = acc;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
reduce_cam_kernel(const float* __restrict__ w21, const float* __restrict__ y,
                  const int* __restrict__ perm,
                  const unsigned char* __restrict__ mask, int O, int V,
                  int rows, float* __restrict__ coup) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= V) return;  // warp-uniform: the whole warp leaves together
  float acc[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) acc[i] = 0.f;
  const size_t base = (size_t)v * rows;
  for (int r = lane; r < rows; r += 32) {
    if (!mask[base + r]) continue;
    const int o = perm[base + r];
    if (o < 0 || o >= O) continue;
    const float* w = w21 + (size_t)o * 21;
    const float y0 = y[3 * (size_t)o], y1 = y[3 * (size_t)o + 1],
                y2 = y[3 * (size_t)o + 2];
#pragma unroll
    for (int i = 0; i < 7; ++i)
      acc[i] += w[3 * i] * y0 + w[3 * i + 1] * y1 + w[3 * i + 2] * y2;
  }
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[i] += __shfl_down_sync(0xffffffffu, acc[i], off);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 7; ++i) coup[7 * (size_t)v + i] = acc[i];
  }
}

}  // namespace

// cam (O,) int32, w21 (O, 21), x (V, 7) f32 -> t (O, 3) f32. A camera id
// outside [0, V) gives a zero row.
extern "C" int sfm_expand_cam(const int* cam, const float* w21, const float* x,
                              int O, int V, float* t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (O + kExpandThreads - 1) / kExpandThreads;
  if (nb > 0) expand_cam_kernel<<<nb, kExpandThreads, 0, s>>>(cam, w21, x, O, V, t);
  return static_cast<int>(cudaGetLastError());
}

// w21 (O, 21), y (O, 3) f32; perm (V * rows,) int32 and mask (V * rows,)
// bool, the camera-major view of the stream -> coup (V, 7) f32.
extern "C" int sfm_reduce_cam(const float* w21, const float* y, const int* perm,
                              const unsigned char* mask, int O, int V, int rows,
                              float* coup, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (V + kWarps - 1) / kWarps;
  if (nb > 0)
    reduce_cam_kernel<<<nb, 32 * kWarps, 0, s>>>(w21, y, perm, mask, O, V, rows, coup);
  return static_cast<int>(cudaGetLastError());
}
