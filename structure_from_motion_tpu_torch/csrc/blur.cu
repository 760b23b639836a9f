// B1: separable Gaussian pyramid blur (all levels of one octave).
//
// Replaces the TPU kernel structure_from_motion_tpu/ops/blur_pallas.py
// (pallas_blur_levels: _hpass_kernel + _vpass_kernel). Level l of the output
// is the zero-padded 'SAME' separable correlation of the (H, W) base with the
// odd 1-D Gaussian taps of level l (radius <= 16), in exact f32 (one fmaf per
// tap in ascending tap order, no reduced-precision pass, no folded taps).
//
// What bounds it on an H100: both rates at once. At the default sigmas (radii
// 4, 6, 9, 12, 15) an octave costs 194 FMAs a pixel, 1.9 GFLOP at 1920x2560
// (0.028 ms at 67 TFLOP/s), against 118 MB that must move (base in, five
// levels out: 0.035 ms at 3.35 TB/s). Neither leaves room for a load beside
// every FMA or for an (L, H, W) intermediate in device memory.
//
// What the design does:
//
// * ONE kernel, nothing but the base read and the levels written. A block
//   stages its tile of the base with the widest level's halo in shared memory
//   once (cp.async, zero outside the image), and for each level runs the
//   H-pass over the tile's rows plus that level's own +-r halo rows into a
//   second shared tile, then the V-pass from it straight to the output. The
//   H-pass is redone for the halo rows, (TH + 2r) / TH of it: 1.09x the FMAs
//   of an octave at TH = 128, 1.17x at TH = 32.
// * One shared load for every 4 to 7 FMAs. A thread makes 8 consecutive
//   outputs ALONG the filter and feeds each input, loaded once, to every
//   output it reaches: (8 + 2r) loads for 8 (2r + 1) FMAs. The radius is a
//   template parameter (a block-uniform switch over 0..16), so both tap loops
//   unroll and every tap sits in a (uniform) register: the inner code is
//   FFMA R, R, UR, R with one LDS for each eight of them, the taps of an
//   output in ascending order, one fmaf each.
// * No bank conflicts: in the H-pass the lanes run down the rows and both
//   shared tiles have odd pitches; in the V-pass the lanes run along x, so
//   the output stores are whole 128-byte lines.
// * The taps travel with the launch, as a by-value parameter in the constant
//   bank (struct BlurTaps): no device buffer, no upload, nothing to cache on
//   the device, and two streams cannot see each other's taps.
// * Tiles by shape: 64 x 128 (256 threads, 101 KB of shared memory at halo
//   15, two blocks an SM, 91 registers) when that gives two blocks for every
//   SM; else 64 x 32 (39 KB, 48 registers, up to five blocks an SM), and when
//   even those are fewer than two an SM (480x640 and below) each level gets
//   its own block (grid.z = L), which re-stages the base from L2 but cuts
//   the one block's chain of levels that sets the time there.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (device time under
// torch.profiler, tools/profile_kernels.py; the first port's two kernels in
// the same run): 1920x2560 x 5 levels 314 -> 93 us, the base blur
// (1920x2560, radius 4) 68 -> 25 us, 240x320 x 5 levels 13.3 -> 6.2 us.
// That is 38% of the bound at 1920x2560. Of the 94 us there
// (tools/kernel_variants.py, which takes parts out) 16 are the staging of the
// tiles (no other work of the block overlaps it), 5 the launch and
// scheduling of 600 blocks, and the two passes take 36 and 35 us where their
// FMAs need 17 and 14: 600 tiles on 264 block slots are 2.3 waves, the third
// a quarter full.
//
// Tried on the card and set aside (same card, tools/kernel_variants.py,
// 1920x2560 x 5 levels unless said; 94 us for the tree's kernel in that run):
// plain loads for the staging, each stored before the next is issued, 138 us
// (the base blur 69 against 25); tiles 64 x 64, 32 x 64 and 64 x 32 at three
// to four blocks an SM 99-103 us, 32 x 32 129 us; tile heights 96 and 120
// rows 101 and 90 us (each image size favours another height); 512 threads
// a block 99 us; 16 outputs a thread in the H-pass 91 us (90 against 91 in a
// second run: no gain), in the V-pass 102, 4 in both 108 against 100 for
// that tile with 8; the taps in ordinary
// registers (through shared memory) 94; one level a block at this size
// 131-156 us (the staging is paid five times); without any shared load
// (inputs made up in registers) 94 and without barriers 90: neither the load
// pipe nor the barriers set the time. Five levels of one radius ran 2-5%
// faster than five radii: instruction fetch is not it either (a loop of the
// same FFMAs alone reached 3.4-3.8 of 4 warp FMAs a clock an SM on this card,
// 1.8-2.6 once 62 KB of them stand in a row).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRadius = 16;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
constexpr int kMaxLevels = 8;  // levels of one launch (the caller splits more)
constexpr long kFillTiles = 264;  // two blocks for each of an H100's 132 SMs

// The taps of one launch, passed BY VALUE: kernel parameters live in the
// constant bank, so no device buffer, no upload and no cache on the device.
// Level l's taps are k[l][0 .. 2 * radius[l]].
struct BlurTaps {
  int radius[kMaxLevels];
  float k[kMaxLevels][kMaxTaps];
};

// 4 bytes from device memory into shared memory without passing a register;
// zero where `valid` is false (a source size of 0 fills the destination).
__device__ __forceinline__ void copy_async_or_zero(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// One level of one tile. sbase: the staged base tile with a halo of `halo`
// pixels on every side (pitch pb, odd); smid: (TH + 2R) x TW H-pass results
// (pitch TW + 1, odd). Both passes give a thread N consecutive outputs ALONG
// the filter and feed each input, loaded once, to every output it reaches.
template <int NT, int TW, int TH, int NH, int NV, int R>
__device__ __forceinline__ void blur_level(const float* __restrict__ sbase, int pb, int halo,
                                           float* __restrict__ smid,
                                           const float* __restrict__ taps, int x0, int y0, int H,
                                           int W, float* __restrict__ out) {
  constexpr int kPm = TW + 1;
  float k[2 * R + 1];
#pragma unroll
  for (int t = 0; t <= 2 * R; ++t) k[t] = taps[t];

  // H-pass: rows y0 - R .. y0 + TH + R of the image; lanes run down the rows
  // (odd pitches: no bank conflict), a thread makes NH outputs along x.
  constexpr int kRows = TH + 2 * R;
  constexpr int kHItems = kRows * (TW / NH);
  for (int item = threadIdx.x; item < kHItems; item += NT) {
    const int row = item % kRows, xc = (item / kRows) * NH;
    if (x0 + xc >= W) continue;  // right of the image: never read
    float* dst = smid + row * kPm + xc;
    const int gy = y0 - R + row;
    float acc[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) acc[i] = 0.f;
    if (gy >= 0 && gy < H) {  // rows outside the image are zero padding
      const float* src = sbase + (halo - R + row) * pb + (halo - R) + xc;
#pragma unroll
      for (int j = 0; j < NH + 2 * R; ++j) {
        const float v = src[j];
#pragma unroll
        for (int i = 0; i < NH; ++i)
          if (j - i >= 0 && j - i <= 2 * R) acc[i] = fmaf(k[j - i], v, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) dst[i] = acc[i];
  }
  __syncthreads();

  // V-pass: lanes run along x (coalesced stores), a thread makes NV outputs
  // down a column.
  constexpr int kVItems = TW * (TH / NV);
  for (int item = threadIdx.x; item < kVItems; item += NT) {
    const int col = item % TW, yc = (item / TW) * NV;
    const int x = x0 + col, y = y0 + yc;
    if (x >= W || y >= H) continue;
    const float* src = smid + yc * kPm + col;
    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NV + 2 * R; ++j) {
      const float v = src[j * kPm];
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (j - i >= 0 && j - i <= 2 * R) acc[i] = fmaf(k[j - i], v, acc[i]);
    }
    float* dst = out + (size_t)y * W + x;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (y + i < H) dst[(size_t)i * W] = acc[i];
  }
  __syncthreads();  // smid is free for the next level
}

template <int NT, int TW, int TH, int NH, int NV, int MINB>
__global__ void __launch_bounds__(NT, MINB)
blur_levels_kernel(const float* __restrict__ base, const __grid_constant__ BlurTaps taps, int L,
                   int max_radius, int H, int W, float* __restrict__ out, int zper,
                   long long out_lane) {
  static_assert(TW % NH == 0 && TH % NV == 0 && NT % 32 == 0, "tile shape");
  extern __shared__ float smem[];
  // gridDim.z is lanes * zper: the lane, then zper = 1 (a block makes every
  // level of its tile) or L (one level). A lane's base is (H, W) after the
  // previous lane's, its levels out_lane floats after the previous lane's.
  const int lane_z = blockIdx.z / zper, zl = blockIdx.z - lane_z * zper;
  base += (size_t)lane_z * H * W;
  out += (size_t)lane_z * out_lane;
  const int halo = zper > 1 ? taps.radius[zl] : max_radius;
  const int wb = TW + 2 * halo, pb = wb + 1, hb = TH + 2 * halo;
  float* sbase = smem;
  float* smid = smem + hb * pb;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;

  // stage the base tile and its halo once for all levels, zero outside the
  // image: asynchronous copies, so a thread's requests are all in flight
  // together instead of one memory latency after another
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int ry = warp; ry < hb; ry += NT / 32) {
    const int gy = y0 - halo + ry;
    const bool row_in = gy >= 0 && gy < H;
    const float* grow = base + (size_t)(row_in ? gy : 0) * W;
    for (int rx = lane; rx < wb; rx += 32) {
      const int gx = x0 - halo + rx;
      const bool in = row_in && gx >= 0 && gx < W;
      copy_async_or_zero(sbase + ry * pb + rx, in ? grow + gx : base, in);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

#define SFM_BLUR_CASE(R)                                                                    \
  case R:                                                                                   \
    blur_level<NT, TW, TH, NH, NV, R>(sbase, pb, halo, smid, taps.k[l], x0, y0, H, W, dst); \
    break;
  for (int l = zl; l < L; l += zper) {
    float* dst = out + (size_t)l * H * W;
    switch (taps.radius[l]) {  // block-uniform; every tap loop unrolls
      SFM_BLUR_CASE(0)
      SFM_BLUR_CASE(1) SFM_BLUR_CASE(2) SFM_BLUR_CASE(3) SFM_BLUR_CASE(4)
      SFM_BLUR_CASE(5) SFM_BLUR_CASE(6) SFM_BLUR_CASE(7) SFM_BLUR_CASE(8)
      SFM_BLUR_CASE(9) SFM_BLUR_CASE(10) SFM_BLUR_CASE(11) SFM_BLUR_CASE(12)
      SFM_BLUR_CASE(13) SFM_BLUR_CASE(14) SFM_BLUR_CASE(15) SFM_BLUR_CASE(16)
    }
  }
#undef SFM_BLUR_CASE
}

template <int NT, int TW, int TH, int NH, int NV, int MINB>
cudaError_t launch(const float* base, const BlurTaps& taps, int L, int lanes, int halo, int H,
                   int W, float* out, long long out_lane, bool split_levels, cudaStream_t s) {
  auto kernel = blur_levels_kernel<NT, TW, TH, NH, NV, MINB>;
  const size_t smem =
      sizeof(float) * (size_t)(TH + 2 * halo) * ((TW + 2 * halo + 1) + (TW + 1));
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  const int zper = split_levels ? L : 1;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, lanes * zper);
  kernel<<<grid, NT, smem, s>>>(base, taps, L, halo, H, W, out, zper, out_lane);
  return cudaGetLastError();
}

}  // namespace

// base (lanes, H, W) f32; taps: a host BlurTaps holding L <= 8 levels, each
// of radius 0..16 (checked by the caller); lane b's L levels go to
// out + b * out_lane, (L, H, W) each. The tile is chosen from ONE lane's
// shape, so every lane runs the arithmetic of a one-lane launch.
extern "C" int sfm_blur_levels_lanes(const float* base, const void* taps_host, int L, int lanes,
                                     int H, int W, long long out_lane, float* out,
                                     void* stream) {
  const BlurTaps& taps = *static_cast<const BlurTaps*>(taps_host);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || lanes > 65535 / 8) return static_cast<int>(cudaErrorInvalidValue);
  int halo = 0;
  for (int l = 0; l < L; ++l) halo = taps.radius[l] > halo ? taps.radius[l] : halo;
  const auto tiles = [&](int tw, int th) { return (long)((W + tw - 1) / tw) * ((H + th - 1) / th); };
  cudaError_t rc;
  if (tiles(64, 128) >= kFillTiles)
    rc = launch<256, 64, 128, 8, 8, 2>(base, taps, L, lanes, halo, H, W, out, out_lane, false, s);
  else
    rc = launch<256, 64, 32, 8, 8, 4>(base, taps, L, lanes, halo, H, W, out, out_lane,
                                      L > 1 && tiles(64, 32) < kFillTiles, s);
  return static_cast<int>(rc);
}
