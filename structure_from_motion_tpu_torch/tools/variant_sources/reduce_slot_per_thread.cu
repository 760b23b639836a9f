// A variant of B6 (reduce_cam) that is NOT part of the library: one block a
// camera like csrc/ba_matvec.cu, but one slot a thread, each thread reading
// its W row as 21 scalars (kK slots' loads in flight), then a shuffle tree
// and the warps in order. tools/kernel_variants.py builds it with kT and kK
// substituted and times it beside the kernel in the tree.
#include <cuda_runtime.h>

constexpr int kT = 128;  // threads a camera
constexpr int kK = 4;    // slots of a thread in flight together

__global__ void __launch_bounds__(kT)
reduce_slot_per_thread(const float* __restrict__ w21, const float* __restrict__ y,
                       const int* __restrict__ perm, const unsigned char* __restrict__ mask,
                       int O, int rows, float* __restrict__ coup) {
  __shared__ float part[kT / 32][7];
  const int v = blockIdx.x;
  const size_t base = (size_t)v * rows;
  float acc[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) acc[i] = 0.f;
  for (int r0 = threadIdx.x; r0 < rows; r0 += kT * kK) {
    int o[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int r = r0 + k * kT;
      o[k] = -1;
      if (r < rows) {
        const unsigned char m = mask[base + r];
        const int p = perm[base + r];
        o[k] = (m && p < O) ? p : -1;
      }
    }
    float w[kK][21], yy[kK][3];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
#pragma unroll
      for (int c = 0; c < 21; ++c) w[k][c] = o[k] >= 0 ? w21[(size_t)o[k] * 21 + c] : 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) yy[k][c] = o[k] >= 0 ? y[(size_t)o[k] * 3 + c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kK; ++k)
#pragma unroll
      for (int i = 0; i < 7; ++i)
        acc[i] += w[k][3 * i] * yy[k][0] + w[k][3 * i + 1] * yy[k][1] + w[k][3 * i + 2] * yy[k][2];
  }
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[i] += __shfl_down_sync(0xffffffffu, acc[i], off);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int i = 0; i < 7; ++i) part[threadIdx.x >> 5][i] = acc[i];
  __syncthreads();
  if (threadIdx.x < 7) {
    float s = part[0][threadIdx.x];
    for (int w_ = 1; w_ < kT / 32; ++w_) s += part[w_][threadIdx.x];
    coup[7 * (size_t)v + threadIdx.x] = s;
  }
}

extern "C" int sfm_reduce_cam(const float* w21, const float* y, const int* perm,
                              const unsigned char* mask, int O, int V, int rows, float* coup,
                              void* stream) {
  reduce_slot_per_thread<<<V, kT, 0, static_cast<cudaStream_t>(stream)>>>(w21, y, perm, mask, O,
                                                                         rows, coup);
  return static_cast<int>(cudaGetLastError());
}
