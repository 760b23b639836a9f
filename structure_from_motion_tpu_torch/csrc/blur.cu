// B1: separable Gaussian pyramid blur (all levels of one octave).
//
// Replaces the TPU kernel structure_from_motion_tpu/ops/blur_pallas.py
// (pallas_blur_levels: _hpass_kernel + _vpass_kernel). Level l of the output
// is the zero-padded 'SAME' separable correlation of the (H, W) base with the
// odd 1-D Gaussian taps of level l (radius <= 16), in exact f32 (one fmaf per
// tap, no reduced-precision pass).
//
// What bounds it on an H100: device-memory bandwidth. Per pixel and level the
// work is 2 x (2r+1) <= 66 FMAs against 12 bytes of traffic (read the base or
// the intermediate, write the intermediate and the output) -- ~5 FLOP/byte,
// far below the card's ~20 FLOP/byte f32 balance point.
//
// What the design does about it: the H-pass stages one row segment plus its
// +-16-pixel halo in shared memory ONCE and writes every level from it, so
// the base is read once for all L levels (as the TPU kernel does). The
// V-pass stages a 64-row column tile plus its +-16-row halo per level, so
// every intermediate value is read from device memory ~1.5 times instead of
// 2r+1 times. Taps come from a tiny (L, 33) table that stays in L1. Any H
// and W: ragged tiles are masked and out-of-image halo entries are zero.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRadius = 16;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;  // row stride of the taps table
constexpr int kHTileX = 128;
constexpr int kHTileY = 4;
constexpr int kVTileX = 32;
constexpr int kVTileY = 64;
constexpr int kVThreadsY = 8;

__global__ void __launch_bounds__(kHTileX * kHTileY)
blur_hpass(const float* __restrict__ base, const float* __restrict__ taps,
           const int* __restrict__ radii, int L, int H, int W,
           float* __restrict__ mid) {
  __shared__ float seg[kHTileY][kHTileX + 2 * kMaxRadius];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kHTileX;
  const int y = blockIdx.y * kHTileY + ty;
  for (int i = tx; i < kHTileX + 2 * kMaxRadius; i += kHTileX) {
    const int gx = x0 - kMaxRadius + i;
    seg[ty][i] = (y < H && gx >= 0 && gx < W) ? base[(size_t)y * W + gx] : 0.f;
  }
  __syncthreads();
  const int x = x0 + tx;
  if (y >= H || x >= W) return;
  for (int l = 0; l < L; ++l) {
    const int r = radii[l];
    const float* k = taps + l * kMaxTaps + (kMaxRadius - r);
    const float* row = &seg[ty][tx + kMaxRadius - r];
    float acc = 0.f;
    for (int t = 0; t <= 2 * r; ++t) acc = fmaf(k[t], row[t], acc);
    mid[((size_t)l * H + y) * W + x] = acc;
  }
}

__global__ void __launch_bounds__(kVTileX * kVThreadsY)
blur_vpass(const float* __restrict__ mid, const float* __restrict__ taps,
           const int* __restrict__ radii, int H, int W,
           float* __restrict__ out) {
  __shared__ float col[kVTileY + 2 * kMaxRadius][kVTileX + 1];
  const int l = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * kVTileX + tx;
  const int y0 = blockIdx.y * kVTileY;
  const float* src = mid + (size_t)l * H * W;
  for (int i = ty; i < kVTileY + 2 * kMaxRadius; i += kVThreadsY) {
    const int gy = y0 - kMaxRadius + i;
    col[i][tx] = (x < W && gy >= 0 && gy < H) ? src[(size_t)gy * W + x] : 0.f;
  }
  __syncthreads();
  if (x >= W) return;
  const int r = radii[l];
  const float* k = taps + l * kMaxTaps + (kMaxRadius - r);
  for (int j = ty; j < kVTileY; j += kVThreadsY) {
    const int y = y0 + j;
    if (y >= H) break;
    float acc = 0.f;
    for (int t = 0; t <= 2 * r; ++t)
      acc = fmaf(k[t], col[j + kMaxRadius - r + t][tx], acc);
    out[((size_t)l * H + y) * W + x] = acc;
  }
}

}  // namespace

// base (H, W); taps (L, 33) with level l's taps centred at column 16;
// radii (L,) each <= 16 (checked by the caller); mid and out (L, H, W).
extern "C" int sfm_blur_levels(const float* base, const float* taps,
                               const int* radii, int L, int H, int W,
                               float* mid, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 hblock(kHTileX, kHTileY);
  const dim3 hgrid((W + kHTileX - 1) / kHTileX, (H + kHTileY - 1) / kHTileY);
  blur_hpass<<<hgrid, hblock, 0, s>>>(base, taps, radii, L, H, W, mid);
  const dim3 vblock(kVTileX, kVThreadsY);
  const dim3 vgrid((W + kVTileX - 1) / kVTileX, (H + kVTileY - 1) / kVTileY, L);
  blur_vpass<<<vgrid, vblock, 0, s>>>(mid, taps, radii, H, W, out);
  return static_cast<int>(cudaGetLastError());
}
