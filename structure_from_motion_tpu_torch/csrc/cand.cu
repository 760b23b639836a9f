// B2: fused DoG candidate response (extrema + contrast + edge + border).
//
// Replaces the TPU kernel structure_from_motion_tpu/ops/features_pallas.py
// (pallas_candidate_response: _cand_kernel). For a (S+2, H, W) DoG stack it
// writes the (S, H, W) map whose entry (s, y, x) is |D| when D = dog[s+1, y, x]
// is a 3x3x3 extremum (>= its window max or <= its window min; ties count),
// |D| > contrast, the 2x2 Hessian has det > 0 and tr^2 r < (r+1)^2 det, and
// (y, x) lies >= border pixels from every edge -- else 0.
//
// What bounds it on an H100: device-memory bandwidth. Each output needs 27
// window taps and 9 Hessian taps but only ~(S+2)/S x 4 bytes of unique input
// and 4 bytes of output.
//
// What the design does about it: one thread per (y, x) loops over the S
// layers; the block stages a 32x8 tile of ALL S+2 layers plus a 1-pixel halo
// in shared memory, so every input value is read from device memory about
// 1.3 times and every tap after that comes from shared memory. Out-of-image
// halo entries are clamped copies -- they only feed pixels inside the border
// band, which are written as 0, so any H and W work.
//
// Exactness: the result must equal the plain PyTorch version bit for bit.
// nvcc would contract the Hessian products into FMAs (one rounding instead
// of two), so the Hessian arithmetic uses the explicitly rounded intrinsics
// __fmul_rn/__fadd_rn/__fsub_rn, which are never contracted.

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kPW = kTX + 2;
constexpr int kPH = kTY + 2;

__global__ void __launch_bounds__(kTX * kTY)
candidate_response(const float* __restrict__ dog, int S, int H, int W,
                   float contrast, float edge_r, float edge_c, int border,
                   float* __restrict__ out) {
  extern __shared__ float tile[];  // (S+2, kPH, kPW)
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int n = (S + 2) * kPH * kPW;
  for (int i = ty * kTX + tx; i < n; i += kTX * kTY) {
    const int layer = i / (kPH * kPW);
    const int rem = i - layer * (kPH * kPW);
    const int py = rem / kPW, px = rem - (rem / kPW) * kPW;
    const int gy = min(max(y0 + py - 1, 0), H - 1);
    const int gx = min(max(x0 + px - 1, 0), W - 1);
    tile[i] = dog[((size_t)layer * H + gy) * W + gx];
  }
  __syncthreads();
  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  const bool inside =
      y >= border && y < H - border && x >= border && x < W - border;
#define AT(layer, dy, dx) tile[((layer) * kPH + ty + 1 + (dy)) * kPW + tx + 1 + (dx)]
  for (int s = 1; s <= S; ++s) {
    float res = 0.f;
    if (inside) {
      const float c = AT(s, 0, 0);
      float mx = c, mn = c;
      for (int l = s - 1; l <= s + 1; ++l)
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            const float v = AT(l, dy, dx);
            mx = fmaxf(mx, v);
            mn = fminf(mn, v);
          }
      const bool is_ext = (c >= mx) || (c <= mn);
      const bool contrast_ok = fabsf(c) > contrast;
      const float c2 = __fmul_rn(2.f, c);
      const float dxx = __fadd_rn(__fsub_rn(AT(s, 0, 1), c2), AT(s, 0, -1));
      const float dyy = __fadd_rn(__fsub_rn(AT(s, 1, 0), c2), AT(s, -1, 0));
      const float dxy = __fmul_rn(
          0.25f, __fadd_rn(__fsub_rn(__fsub_rn(AT(s, 1, 1), AT(s, 1, -1)),
                                     AT(s, -1, 1)),
                           AT(s, -1, -1)));
      const float tr = __fadd_rn(dxx, dyy);
      const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
      const bool edge_ok =
          det > 0.f && __fmul_rn(__fmul_rn(tr, tr), edge_r) < __fmul_rn(edge_c, det);
      if (is_ext && contrast_ok && edge_ok) res = fabsf(c);
    }
    out[((size_t)(s - 1) * H + y) * W + x] = res;
  }
#undef AT
}

}  // namespace

// dog (S+2, H, W) -> out (S, H, W); edge_c = (edge_r + 1)^2 in f32.
extern "C" int sfm_candidate_response(const float* dog, int S, int H, int W,
                                      float contrast, float edge_r,
                                      float edge_c, int border, float* out,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kTX, kTY);
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY);
  const size_t smem = sizeof(float) * (S + 2) * kPH * kPW;
  candidate_response<<<grid, block, smem, s>>>(dog, S, H, W, contrast, edge_r,
                                               edge_c, border, out);
  return static_cast<int>(cudaGetLastError());
}
