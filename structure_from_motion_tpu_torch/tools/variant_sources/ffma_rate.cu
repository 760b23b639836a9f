// Not part of the library: the FMA rate the card gives to the inner code of
// csrc/blur.cu alone (8 accumulators, each input fed to every output it
// reaches, K taps in uniform registers), with no memory access at all.
// REP copies of the K-tap body stand in a row inside a loop of n rounds:
// REP = 1 is a loop that fits the instruction cache, REP = 16 is 63 KB of
// straight-line code. tools/kernel_variants.py builds and times it.
#include <cuda_runtime.h>

struct Taps {
  float k[40];
};

template <int K, int REP>
__global__ void __launch_bounds__(256)
ffma_rate(const __grid_constant__ Taps taps, int n, float seed, float* out) {
  float k[K];
#pragma unroll
  for (int t = 0; t < K; ++t) k[t] = taps.k[t];
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = threadIdx.x * seed + i;
  float v = seed * threadIdx.x;
#pragma unroll 1
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int j = 0; j < K + 7; ++j) {
        v = __int_as_float(__float_as_int(v) + 1);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (j - i >= 0 && j - i < K) acc[i] = fmaf(k[j - i], v, acc[i]);
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += acc[i];
  if (s == 12345.678f) out[0] = s;  // keeps the sums alive
}

// which: 0 = K 31, REP 1; 1 = K 31, REP 16; 2 = K 9, REP 1; 3 = K 31, REP 4
extern "C" int sfm_ffma_rate(int which, int blocks, int n, float* out, void* stream) {
  Taps t;
  for (int i = 0; i < 40; ++i) t.k[i] = 0.001f * i;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) ffma_rate<31, 1><<<blocks, 256, 0, s>>>(t, n, 1e-3f, out);
  if (which == 1) ffma_rate<31, 16><<<blocks, 256, 0, s>>>(t, n, 1e-3f, out);
  if (which == 2) ffma_rate<9, 1><<<blocks, 256, 0, s>>>(t, n, 1e-3f, out);
  if (which == 3) ffma_rate<31, 4><<<blocks, 256, 0, s>>>(t, n, 1e-3f, out);
  return static_cast<int>(cudaGetLastError());
}
