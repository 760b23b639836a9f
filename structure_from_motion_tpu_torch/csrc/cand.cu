// B2: fused DoG candidate response (extrema + contrast + edge + border), with
// the 8x8 block argmax that follows it fused in.
//
// Replaces the TPU kernel structure_from_motion_tpu/ops/features_pallas.py
// (pallas_candidate_response: _cand_kernel). The masked response of a
// (S+2, H, W) DoG stack at (s, y, x) is |D| when D = dog[s+1, y, x] is a 3x3x3
// extremum (>= its window max or <= its window min; ties count),
// |D| > contrast, the 2x2 Hessian has det > 0 and tr^2 r < (r+1)^2 det, and
// (y, x) lies >= border pixels from every edge -- else 0. Two entry points:
//
// * sfm_candidate_block_max_lanes (the detector's path when 8 divides H and W):
//   writes, for every 8x8 block of every layer, the largest masked response
//   and where it sits in the block (dy * 8 + dx; among equal values the first
//   in row-major order; 0 for a block of zeros). The TPU kernel stops at the
//   (S, H, W) map and leaves the block max to two single-axis reductions; here
//   the map is never written.
// * sfm_candidate_response_lanes (any H and W; the detector's path for topk_block
//   <= 1 and for sizes 8 does not divide): writes the (S, H, W) map.
//
// What bounds them on an H100: device-memory bandwidth. A pixel of the stack
// costs ~120 compares and adds but only (S+2)/S x 4 bytes of unique input.
// The map is 3/8 of the bytes of the map kernel (59 of 157 MB at
// (5, 1920, 2560)), and the reductions after it read it back three times;
// the fused kernel moves the 98 MB of input and 1.8 MB of output.
//
// What the fused design does (candidate_block_max below):
//
// * No shared memory, no barrier. A thread owns C neighbouring columns (one
//   16-, 8- or 4-byte load a layer and row) and walks DOWN a strip of R rows,
//   keeping the three newest rows of all S+2 layers in registers. Each input
//   is loaded about once: a warp's 32 x C columns start 4 columns left of its
//   first 8x8 block, so its loads stay aligned and its one or two outer lanes
//   on each side are halo lanes that only feed their neighbours (1.14x the
//   columns at C = 2), and a strip re-reads its two outer rows ((R + 2) / R).
// * The 3x3 window max/min of a layer is formed once and shared: a thread
//   reduces each layer's three rows (column max/min), combines three layers
//   for an output layer, and takes the x-neighbours of that by two
//   __shfl_sync each. The Hessian is computed only where a pixel passed the
//   extremum and contrast tests, which is rare: its taps come from the same
//   registers, but for the columns just left and right of the thread's own,
//   which that branch loads from memory (L1/L2 hits) rather than every row
//   paying six shuffles and 18 registers for them.
// * The row after next is loaded before the current row is computed, so a
//   warp always has S+2 loads in flight.
// * The 8x8 block max is kept in registers as (value, position) with a
//   strict compare in row-major order, so the first of equal values wins;
//   after 8 rows the 8 / C lanes of a block merge by shuffles (ties to the
//   lower position) and one lane writes.
// * One tile for every shape (kC, kR, kU below; C columns a thread, R rows a
//   strip, the row loop unrolled by U): <2, 8, 2>, 100 registers at S = 3,
//   five blocks of four warps an SM. 8-row strips are the shortest chain of
//   dependent row loads, which sets the time of the small octaves (one wave
//   or less), and two rows in one loop body overlap their latencies.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (device time under
// torch.profiler, tools/profile_kernels.py and tools/kernel_variants.py, on
// the DoG stacks of a rendered 960x1280 frame; the map kernel in the same
// run): (5, 1920, 2560) 128 us for the map alone -> 52 us fused (57% of the
// 30 us the 100 MB need), and the whole candidate stage (map kernel + four
// reductions, 0.42 ms by events) -> the fused kernel alone; 960x1280 34 ->
// 12 us, 480x640 9.5 -> 5.9 us, 240x320 4.0 -> 5.1 us, 120x160 4.8 us (one
// wave either way; the fused kernel's warps run a chain of 10 row loads).
//
// Tried on the card and set aside (tools/kernel_variants.py, same card,
// (5, 1920, 2560) unless said): C = 4 (16-byte loads, 142-201 registers) 56-63
// us at R = 8 and 58-72 at R = 16..32 (fewer warps an SM, then fewer warps
// than slots); C = 1 60-66; <2, 8, 1> 53.7, <2, 16, 2> 52.9, <2, 8, 3> 57.9;
// <2, 8, 1> held to five blocks an SM 49.8 and 53.1 in two runs there but
// 13.7 against 12.4 at 960x1280; <1, 8, 2> 4.9 and 4.7 against 5.1 and 4.8 at the two smallest
// shapes. A first version kept the Hessian's left and right taps in
// registers, one shuffle a layer, row and side: 58 us with <4, 8, 1>, its
// best tile (154 registers); loading them in the rare branch instead gave
// 56 with that tile and made C = 2 the better one. Loading the next row
// after the compute instead of before it: 47.5 and 51.9 us against 52.6 and
// 52.8 in two runs at (5, 1920, 2560), but 13.1, 6.5, 5.8 and 5.5 us against
// 12.5, 6.0, 5.2 and 4.8 at the four smaller shapes, whose time is the chain
// of row loads: the prefetch stays. 256 threads a block 53.7, at least six
// blocks an SM (80 registers, spills) 66. With no loads in the row loop the
// kernel takes 35 us, with no candidate ever passing 52.3, without the
// Hessian arithmetic 52.7: the row loads and the window arithmetic overlap
// only in part, and the rare branch costs nothing now.
//
// Out-of-image halo entries are clamped copies -- they only feed pixels inside
// the border band (border >= 1), which are written as 0.
//
// Exactness: both results must equal the plain PyTorch version bit for bit.
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
  // blockIdx.z is the lane: (S+2, H, W) in, (S, H, W) out a lane
  dog += (size_t)blockIdx.z * (S + 2) * H * W;
  out += (size_t)blockIdx.z * S * H * W;
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

// ---------------------------------------------------------------------------
// Fused: masked response + 8x8 block argmax.

constexpr int kBlock = 8;          // the block whose maximum is kept
constexpr int kFusedThreads = 128; // four independent warps

template <int C>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int S, int C>
__device__ __forceinline__ void load_row(const float* __restrict__ col, size_t layer_stride,
                                         int W, int y, float (&v)[S + 2][C]) {
#pragma unroll
  for (int l = 0; l < S + 2; ++l) load_cols<C>(col + l * layer_stride + (size_t)y * W, v[l]);
}

template <int S, int C>
__device__ __forceinline__ void copy_row(float (&dst)[S + 2][C], float (&src)[S + 2][C]) {
#pragma unroll
  for (int l = 0; l < S + 2; ++l)
#pragma unroll
    for (int c = 0; c < C; ++c) dst[l][c] = src[l][c];
}

template <int S, int C, int R, int U>
__global__ void __launch_bounds__(kFusedThreads)
candidate_block_max(const float* __restrict__ dog, int H, int W, float contrast,
                    float edge_r, float edge_c, int border, float* __restrict__ cand,
                    int* __restrict__ pos) {
  constexpr int kHalo = 4 / C;                  // halo lanes on each side
  constexpr int kOutCols = (32 - 2 * kHalo) * C;  // 120, 56 or 24: whole blocks
  constexpr int kLanesPerBlock = kBlock / C;
  // blockIdx.y is the lane: (S+2, H, W) in, (S, H/8, W/8) out a lane
  dog += (size_t)blockIdx.y * (S + 2) * H * W;
  cand += (size_t)blockIdx.y * S * (H / kBlock) * (W / kBlock);
  pos += (size_t)blockIdx.y * S * (H / kBlock) * (W / kBlock);
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (kFusedThreads / 32) + (threadIdx.x >> 5);
  const int warps_x = (W + kOutCols - 1) / kOutCols;
  const int y0 = (warp / warps_x) * R;
  if (y0 >= H) return;  // the whole warp leaves together
  const int x = (warp % warps_x) * kOutCols - 4 + lane * C;  // this thread's first column
  // columns outside the image load an aligned in-image copy (border-masked)
  const float* col = dog + min(max(x, 0), W - C);
  const size_t layer_stride = (size_t)H * W;
  const int rows = min(R, H - y0);  // a multiple of 8

  bool col_in[C];
#pragma unroll
  for (int c = 0; c < C; ++c) col_in[c] = x + c >= border && x + c < W - border;
  const bool writer = lane >= kHalo && lane < 32 - kHalo &&
                      (lane - kHalo) % kLanesPerBlock == 0 && x < W;
  const int wb = W / kBlock;
  const size_t out_layer = (size_t)(H / kBlock) * wb;

  float a[S + 2][C], b[S + 2][C], c3[S + 2][C];  // rows y - 1, y, y + 1
  float nxt[S + 2][C];
  load_row<S, C>(col, layer_stride, W, max(y0 - 1, 0), a);
  load_row<S, C>(col, layer_stride, W, y0, b);
  load_row<S, C>(col, layer_stride, W, min(y0 + 1, H - 1), c3);

  float best[S];
  int bpos[S];
#pragma unroll
  for (int s = 0; s < S; ++s) { best[s] = 0.f; bpos[s] = 0; }

#pragma unroll U
  for (int i = 0; i < rows; ++i) {
    const int y = y0 + i;
    // in flight while this row is computed
    load_row<S, C>(col, layer_stride, W, min(y + 2, H - 1), nxt);
    const bool row_in = y >= border && y < H - border;
    const int dy8 = (i & (kBlock - 1)) * kBlock;

    // column max/min of the three rows, every layer
    float cmx[S + 2][C], cmn[S + 2][C];
#pragma unroll
    for (int l = 0; l < S + 2; ++l)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        cmx[l][c] = fmaxf(fmaxf(a[l][c], b[l][c]), c3[l][c]);
        cmn[l][c] = fminf(fminf(a[l][c], b[l][c]), c3[l][c]);
      }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // three layers, then the x-neighbours: mx[0] and mx[C + 1] by shuffle
      float mx[C + 2], mn[C + 2];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        mx[c + 1] = fmaxf(fmaxf(cmx[s][c], cmx[s + 1][c]), cmx[s + 2][c]);
        mn[c + 1] = fminf(fminf(cmn[s][c], cmn[s + 1][c]), cmn[s + 2][c]);
      }
      mx[0] = __shfl_up_sync(0xffffffffu, mx[C], 1);
      mn[0] = __shfl_up_sync(0xffffffffu, mn[C], 1);
      mx[C + 1] = __shfl_down_sync(0xffffffffu, mx[1], 1);
      mn[C + 1] = __shfl_down_sync(0xffffffffu, mn[1], 1);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float ctr = b[s + 1][c];
        const float wmax = fmaxf(fmaxf(mx[c], mx[c + 1]), mx[c + 2]);
        const float wmin = fminf(fminf(mn[c], mn[c + 1]), mn[c + 2]);
        const float mag = fabsf(ctr);
        if ((ctr >= wmax || ctr <= wmin) && mag > contrast && row_in && col_in[c]) {
          // rare: the taps left and right of the thread's own columns come
          // from memory (a candidate is inside the border, so they exist)
          const float* ctr_ptr = dog + (s + 1) * layer_stride + (size_t)y * W + x + c;
          const float l0 = c == 0 ? __ldg(ctr_ptr - 1) : b[s + 1][c == 0 ? 0 : c - 1];
          const float r0 = c == C - 1 ? __ldg(ctr_ptr + 1) : b[s + 1][c == C - 1 ? c : c + 1];
          const float lu = c == 0 ? __ldg(ctr_ptr - W - 1) : a[s + 1][c == 0 ? 0 : c - 1];
          const float ru = c == C - 1 ? __ldg(ctr_ptr - W + 1) : a[s + 1][c == C - 1 ? c : c + 1];
          const float ld = c == 0 ? __ldg(ctr_ptr + W - 1) : c3[s + 1][c == 0 ? 0 : c - 1];
          const float rd = c == C - 1 ? __ldg(ctr_ptr + W + 1) : c3[s + 1][c == C - 1 ? c : c + 1];
          const float c2 = __fmul_rn(2.f, ctr);
          const float dxx = __fadd_rn(__fsub_rn(r0, c2), l0);
          const float dyy = __fadd_rn(__fsub_rn(c3[s + 1][c], c2), a[s + 1][c]);
          const float dxy =
              __fmul_rn(0.25f, __fadd_rn(__fsub_rn(__fsub_rn(rd, ld), ru), lu));
          const float tr = __fadd_rn(dxx, dyy);
          const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
          const bool edge_ok = det > 0.f &&
                               __fmul_rn(__fmul_rn(tr, tr), edge_r) < __fmul_rn(edge_c, det);
          // rows and columns come in ascending order: strict > keeps the first
          if (edge_ok && mag > best[s]) {
            best[s] = mag;
            bpos[s] = dy8 + ((x + c) & (kBlock - 1));
          }
        }
      }
    }

    if ((i & (kBlock - 1)) == kBlock - 1) {
      // the lanes of a block merge into its first lane; ties to the lower
      // position, which is the earlier one in row-major order
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int off = kLanesPerBlock / 2; off >= 1; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, best[s], off);
          const int op = __shfl_down_sync(0xffffffffu, bpos[s], off);
          if (ov > best[s] || (ov == best[s] && op < bpos[s])) {
            best[s] = ov;
            bpos[s] = op;
          }
        }
        if (writer) {
          const size_t o = s * out_layer + (size_t)(y / kBlock) * wb + x / kBlock;
          cand[o] = best[s];
          pos[o] = bpos[s];
        }
        best[s] = 0.f;
        bpos[s] = 0;
      }
    }
    copy_row<S, C>(a, b);
    copy_row<S, C>(b, c3);
    copy_row<S, C>(c3, nxt);
  }
}

template <int S, int C, int R, int U>
cudaError_t launch_block_max(const float* dog, int lanes, int H, int W, float contrast,
                             float edge_r, float edge_c, int border, float* cand, int* pos,
                             cudaStream_t s) {
  constexpr int kOutCols = (32 - 2 * (4 / C)) * C;
  const int warps = ((W + kOutCols - 1) / kOutCols) * ((H + R - 1) / R);
  const int per_block = kFusedThreads / 32;
  const dim3 grid((warps + per_block - 1) / per_block, lanes);
  candidate_block_max<S, C, R, U><<<grid, kFusedThreads, 0, s>>>(
      dog, H, W, contrast, edge_r, edge_c, border, cand, pos);
  return cudaGetLastError();
}

// Which tile takes which shape (a 960x1280 frame gives 1920x2560, 960x1280,
// 480x640, 240x320, 120x160): one tile, <2, 8, 2>, takes them all. It is
// within 0.3 us of the best tile measured at every one of the five shapes
// (52.5, 12.4, 5.9, 5.1, 4.8 us; the notes at the head of the file), so the
// shape chooses nothing. The other values of C, R and U that the templates
// take are built only by tools/kernel_variants.py, which replaces this line.
constexpr int kC = 2, kR = 8, kU = 2;

}  // namespace

// dog (lanes, S+2, H, W) -> out (lanes, S, H, W); edge_c = (edge_r + 1)^2 in f32.
extern "C" int sfm_candidate_response_lanes(const float* dog, int lanes, int S, int H, int W,
                                            float contrast, float edge_r, float edge_c,
                                            int border, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTX, kTY);
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, lanes);
  const size_t smem = sizeof(float) * (S + 2) * kPH * kPW;
  candidate_response<<<grid, block, smem, s>>>(dog, S, H, W, contrast, edge_r,
                                               edge_c, border, out);
  return static_cast<int>(cudaGetLastError());
}

// dog (lanes, S+2, H, W), 8 | H, 8 | W, 1 <= S <= 4, border >= 1 -> cand, pos
// (lanes, S, H/8, W/8); edge_c = (edge_r + 1)^2 in f32.
extern "C" int sfm_candidate_block_max_lanes(const float* dog, int lanes, int S, int H, int W,
                                             float contrast, float edge_r, float edge_c,
                                             int border, float* cand, int* pos, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0 || H % kBlock || W % kBlock || border < 1 || lanes < 1 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (S) {
    case 1: return static_cast<int>(launch_block_max<1, kC, kR, kU>(dog, lanes, H, W, contrast, edge_r, edge_c, border, cand, pos, s));
    case 2: return static_cast<int>(launch_block_max<2, kC, kR, kU>(dog, lanes, H, W, contrast, edge_r, edge_c, border, cand, pos, s));
    case 3: return static_cast<int>(launch_block_max<3, kC, kR, kU>(dog, lanes, H, W, contrast, edge_r, edge_c, border, cand, pos, s));
    case 4: return static_cast<int>(launch_block_max<4, kC, kR, kU>(dog, lanes, H, W, contrast, edge_r, edge_c, border, cand, pos, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
