// B4: fused bundle-adjustment residual / Jacobian / normal-equation blocks.
//
// Replaces the TPU kernel structure_from_motion_tpu/ops/ba_pallas.py
// (pallas_ba_blocks: _assemble_kernel). Per observation o: R from the
// normalised quaternion, residual meas - proj in normalised camera
// coordinates, Huber sqrt-IRLS weight x validity, the closed-form 2x3 point
// and 2x7 camera Jacobians (d vec(R)/d q from the RAW quaternion), and the
// blocks DtD_o = Jp^T Jp (3x3), W_o = Jc^T Jp (7x3), b_p,o = Jp^T r (3).
// Per camera v: U_v = sum Jc^T Jc (7x7), b_c,v = sum Jc^T r (7) and the
// camera's share of the cost sum r^2.
//
// What bounds it on an H100: device-memory traffic. An observation needs
// 56 bytes in (camera id, C, q, X, uv, weight) and 132 bytes out (DtD, W,
// b_p) for ~400 FLOPs of closed-form math: 188 B x 262,144 observations =
// 49 MB, 0.015 ms at 3.35 TB/s; the arithmetic is a tenth of that at the
// CUDA cores' f32 rate. So the design moves each of those bytes once, in
// whole lines, and keeps the camera reduction's own traffic and work
// proportional to the observations, not to observations x cameras.
//
// What the design does:
//
// * One thread per observation does the closed form in registers. C and X
//   (stride 12 bytes) arrive through shared memory, and DtD (36 B), W (84 B)
//   and b_p (12 B) leave through it, so that every warp-wide access to
//   device memory is a run of consecutive words (16 bytes a thread on full
//   blocks); q and uv are one aligned 16- and 8-byte load a thread.
// * The camera payload is 36 wide, not 57: the 28 distinct entries of the
//   symmetric U, then b_c (7) and r^2 (1). It is parked in shared memory.
// * Camera reduction, stage 1 (same kernel): the block orders its 128
//   (camera, lane) keys by a stable counting rank in shared memory, so equal
//   cameras form runs in lane order. Warp w sums runs w, w + 4, ... with one
//   lane per payload entry, walking each run in lane order, and writes ONE
//   144-byte row per camera PRESENT in the block, plus a one-byte slot
//   table entry (camera, block) -> row. Work and traffic are O(128 x 36) a
//   block whatever V is: the V x 57 x 128 scan and the (blocks, V, 57) table
//   of the first port are gone. Scratch is blocks x min(128, V) rows of 144
//   bytes (34 MB reserved at V = 500, of which only rows that exist are
//   written) and blocks x V bytes of slots, which a block writes as one run.
// * Stage 2 (second kernel): one block per camera; 28 groups of 36 threads
//   each walk a fixed contiguous range of blocks in order, reading the slot
//   byte and, where the camera is present, its row; the 28 partial sums
//   are added in group order and U is mirrored on the way out.
//
// No float atomics: every sum has one fixed order given the inputs, so two
// launches give the same bits. A segment sum over a camera-major view of
// the stream (as B6 uses) would need an argsort per call, which the
// per-frame path (V = 16, host-bound) cannot pay and only the PCG path
// builds; the in-block ordering costs no extra launch and no PyTorch call,
// and serves both paths with one kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kBO = 128;     // observations per block
constexpr int kP = 36;       // payload: 28 (upper U) + 7 (b_c) + 1 (cost)
constexpr int kPS = 37;      // padded payload stride in shared memory
constexpr int kOutP = 57;    // output row: U (49) | b_c (7) | cost (1)
constexpr int kGroups = 28;  // stage-2 groups of kP threads
constexpr int kInFlight = 8; // stage-2 row loads a thread keeps in flight
constexpr int kNoKey = 0x00ffffff;  // above every camera id; key * 128 fits an int
constexpr int kNoSlot = 255;
// per-observation output staging (words): DtD | W | b_p
constexpr int kOffW = kBO * 9, kOffB = kBO * 30, kStage = kBO * 33;

// Copy n words from shared to device memory, consecutive threads on
// consecutive words; 16 bytes a thread when the block is full.
__device__ __forceinline__ void store_block(float* __restrict__ dst,
                                            const float* src, int n,
                                            bool full, int t) {
  if (full) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = t; i < n / 4; i += kBO) d4[i] = s4[i];
  } else {
    for (int i = t; i < n; i += kBO) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kBO)
ba_assemble(const int* __restrict__ cam, const float* __restrict__ Cg,
            const float* __restrict__ qg, const float* __restrict__ Xg,
            const float* __restrict__ uvg, const float* __restrict__ wg, int O,
            int V, float huber, float* __restrict__ dtd_out,
            float* __restrict__ wblk_out, float* __restrict__ bp_out,
            float* __restrict__ rows, unsigned char* __restrict__ slot,
            int rmax) {
  __shared__ float pay[kBO * kPS];
  __shared__ __align__(16) float so[kStage];
  __shared__ float sC[kBO * 3], sX[kBO * 3];
  __shared__ __align__(16) int keys[kBO];
  __shared__ int skey[kBO], order[kBO], seg_start[kBO + 1];
  __shared__ unsigned headmask[kBO / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x, nb = gridDim.x;
  {  // blockIdx.y is the lane: O observations and their scratch a lane
    const size_t lo = (size_t)blockIdx.y * O;
    cam += lo; Cg += 3 * lo; qg += 4 * lo; Xg += 3 * lo; uvg += 2 * lo; wg += lo;
    dtd_out += 9 * lo; wblk_out += 21 * lo; bp_out += 3 * lo;
    rows += (size_t)blockIdx.y * nb * rmax * kP;
    slot += (size_t)blockIdx.y * nb * V;
  }
  const int o0 = b * kBO;
  const int o = o0 + t;
  const int n_here = min(kBO, O - o0);

  for (int i = t; i < 3 * n_here; i += kBO) {
    sC[i] = Cg[(size_t)3 * o0 + i];
    sX[i] = Xg[(size_t)3 * o0 + i];
  }
  for (int v = t; v < V; v += kBO) slot[(size_t)b * V + v] = kNoSlot;
  int key = kNoKey;
  __syncthreads();

  if (o < O) {
    const int cv = cam[o];
    if (cv >= 0 && cv < V) key = cv;
    const float C0 = sC[3 * t], C1 = sC[3 * t + 1], C2 = sC[3 * t + 2];
    const float4 qv = reinterpret_cast<const float4*>(qg)[o];
    const float qw = qv.x, qx = qv.y, qy = qv.z, qz = qv.w;
    const float X0 = sX[3 * t], X1 = sX[3 * t + 1], X2 = sX[3 * t + 2];
    const float2 mv = reinterpret_cast<const float2*>(uvg)[o];
    const float m0 = mv.x, m1 = mv.y;
    const float wv = wg[o];

    const float inv_n =
        1.f / sqrtf(fmaxf(qw * qw + qx * qx + qy * qy + qz * qz, 1e-24f));
    const float w_ = qw * inv_n, x_ = qx * inv_n, y_ = qy * inv_n,
                z_ = qz * inv_n;
    const float ww = w_ * w_, xx = x_ * x_, yy = y_ * y_, zz = z_ * z_;
    const float wx = w_ * x_, wy = w_ * y_, wz = w_ * z_;
    const float xy = x_ * y_, xz = x_ * z_, yz = y_ * z_;
    const float r00 = ww + xx - yy - zz, r01 = 2.f * (xy - wz),
                r02 = 2.f * (xz + wy);
    const float r10 = 2.f * (xy + wz), r11 = ww - xx + yy - zz,
                r12 = 2.f * (yz - wx);
    const float r20 = 2.f * (xz - wy), r21 = 2.f * (yz + wx),
                r22 = ww - xx - yy + zz;

    const float d0 = X0 - C0, d1 = X1 - C1, d2 = X2 - C2;
    const float x0 = r00 * d0 + r10 * d1 + r20 * d2;  // x = R^T d
    const float x1 = r01 * d0 + r11 * d1 + r21 * d2;
    const float x2 = r02 * d0 + r12 * d1 + r22 * d2;
    const float z = fabsf(x2) < 1e-12f ? 1e-12f : x2;
    const float inv_z = 1.f / z;
    const float u = x0 * inv_z, v = x1 * inv_z;
    float res0 = m0 - u, res1 = m1 - v;

    float rw = wv;
    if (huber > 0.f) {
      const float nrm = sqrtf(res0 * res0 + res1 * res1);
      const float hw = nrm <= huber ? 1.f : huber / fmaxf(nrm, 1e-12f);
      rw = sqrtf(hw) * wv;
    }

    const float jp00 = (r00 - u * r02) * inv_z, jp01 = (r10 - u * r12) * inv_z,
                jp02 = (r20 - u * r22) * inv_z;
    const float jp10 = (r01 - v * r02) * inv_z, jp11 = (r11 - v * r12) * inv_z,
                jp12 = (r21 - v * r22) * inv_z;

    const float W2 = 2.f * qw, X2q = 2.f * qx, Y2 = 2.f * qy, Z2 = 2.f * qz;
    const float dx0[4] = {W2 * d0 + Z2 * d1 - Y2 * d2, X2q * d0 + Y2 * d1 + Z2 * d2,
                          -Y2 * d0 + X2q * d1 - W2 * d2, -Z2 * d0 + W2 * d1 + X2q * d2};
    const float dx1[4] = {-Z2 * d0 + W2 * d1 + X2q * d2, Y2 * d0 - X2q * d1 + W2 * d2,
                          X2q * d0 + Y2 * d1 + Z2 * d2, -W2 * d0 - Z2 * d1 + Y2 * d2};
    const float dx2[4] = {Y2 * d0 - X2q * d1 + W2 * d2, Z2 * d0 - W2 * d1 - X2q * d2,
                          W2 * d0 + Z2 * d1 - Y2 * d2, X2q * d0 + Y2 * d1 + Z2 * d2};

    res0 *= rw;
    res1 *= rw;
    float row0[7], row1[7], p0[3], p1[3];
    p0[0] = jp00 * rw; p0[1] = jp01 * rw; p0[2] = jp02 * rw;
    p1[0] = jp10 * rw; p1[1] = jp11 * rw; p1[2] = jp12 * rw;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      row0[i] = -p0[i];
      row1[i] = -p1[i];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      row0[3 + k] = (dx0[k] - u * dx2[k]) * inv_z * rw;
      row1[3 + k] = (dx1[k] - v * dx2[k]) * inv_z * rw;
    }

    // strides 9, 21, 3 and 37 are odd: no bank conflicts across a warp
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        so[t * 9 + 3 * i + j] = p0[i] * p0[j] + p1[i] * p1[j];
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        so[kOffW + t * 21 + 3 * i + j] = row0[i] * p0[j] + row1[i] * p1[j];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      so[kOffB + t * 3 + j] = p0[j] * res0 + p1[j] * res1;

    float* my = pay + t * kPS;
    int idx = 0;
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int j = i; j < 7; ++j)
        my[idx++] = row0[i] * row0[j] + row1[i] * row1[j];
#pragma unroll
    for (int i = 0; i < 7; ++i) my[28 + i] = row0[i] * res0 + row1[i] * res1;
    my[35] = res0 * res0 + res1 * res1;
  }
  keys[t] = key * kBO + t;
  __syncthreads();

  // the per-observation blocks leave in whole lines
  const bool full = n_here == kBO;
  store_block(dtd_out + (size_t)o0 * 9, so, n_here * 9, full, t);
  store_block(wblk_out + (size_t)o0 * 21, so + kOffW, n_here * 21, full, t);
  store_block(bp_out + (size_t)o0 * 3, so + kOffB, n_here * 3, full, t);

  // stable counting rank of (camera, lane): equal cameras become runs in
  // lane order; lanes without a camera (tail, id outside [0, V)) sort last
  const int ck = key * kBO + t;  // (camera, lane) as one number
  int rank = 0;
#pragma unroll 8
  for (int j = 0; j < kBO / 4; ++j) {
    const int4 k4 = reinterpret_cast<const int4*>(keys)[j];
    rank += (k4.x < ck) + (k4.y < ck) + (k4.z < ck) + (k4.w < ck);
  }
  order[rank] = t;
  skey[rank] = key;
  __syncthreads();

  const int kp = skey[t];  // thread t now looks at sorted position t
  const bool head = t == 0 || skey[t - 1] != kp;
  const unsigned hm = __ballot_sync(0xffffffffu, head);
  if (lane == 0) headmask[warp] = hm;
  __syncthreads();
  int before = 0, nseg = 0;
#pragma unroll
  for (int w = 0; w < kBO / 32; ++w) {
    const int c = __popc(headmask[w]);
    if (w < warp) before += c;
    nseg += c;
  }
  if (head) {
    const int s = before + __popc(hm & ((2u << lane) - 1u)) - 1;
    seg_start[s] = t;
    if (kp != kNoKey) slot[(size_t)b * V + kp] = (unsigned char)s;
  }
  if (t == 0) seg_start[nseg] = kBO;
  __syncthreads();

  // one warp per run, one lane per payload entry, the run in lane order
  for (int s = warp; s < nseg; s += kBO / 32) {
    const int p0 = seg_start[s], p1 = seg_start[s + 1];
    if (skey[p0] == kNoKey) continue;  // warp-uniform
    float a0 = 0.f, a1 = 0.f;
    for (int p = p0; p < p1; ++p) {
      const float* src = pay + order[p] * kPS;
      a0 += src[lane];
      if (lane < kP - 32) a1 += src[32 + lane];
    }
    float* r = rows + ((size_t)b * rmax + s) * kP;
    r[lane] = a0;
    if (lane < kP - 32) r[32 + lane] = a1;
  }
}

// One block per camera: group g of kP threads walks blocks
// [g * chunk, (g + 1) * chunk) in order; the groups' sums are added in
// group order; the upper triangle of U is mirrored on the way out.
__global__ void __launch_bounds__(kP * kGroups)
ba_reduce_rows(const float* __restrict__ rows,
               const unsigned char* __restrict__ slot, int nb, int V,
               int rmax, float* __restrict__ out) {
  __shared__ float part[kGroups * kP];
  // blockIdx.y is the lane: its own scratch and its own V output rows
  rows += (size_t)blockIdx.y * nb * rmax * kP;
  slot += (size_t)blockIdx.y * nb * V;
  out += (size_t)blockIdx.y * V * kOutP;
  const int v = blockIdx.x;
  const int c = threadIdx.x % kP, g = threadIdx.x / kP;
  const int chunk = (nb + kGroups - 1) / kGroups;
  const int b0 = g * chunk, b1 = min(nb, b0 + chunk);
  const unsigned char* sv = slot + v;  // slot[b * V + v]
  float acc = 0.f;
  for (int b = b0; b < b1; b += kInFlight) {
    int s[kInFlight];
    float x[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) s[k] = b + k < b1 ? sv[(size_t)(b + k) * V] : kNoSlot;
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      x[k] = s[k] != kNoSlot ? rows[((size_t)(b + k) * rmax + s[k]) * kP + c] : 0.f;
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) acc += x[k];
  }
  part[g * kP + c] = acc;
  __syncthreads();
  if (g != 0) return;
  float tot = 0.f;
  for (int gg = 0; gg < kGroups; ++gg) tot += part[gg * kP + c];
  float* dst = out + (size_t)v * kOutP;
  if (c < 28) {
    int i = 0, rem = c;
    while (rem >= 7 - i) {
      rem -= 7 - i;
      ++i;
    }
    const int j = i + rem;
    dst[7 * i + j] = tot;
    dst[7 * j + i] = tot;
  } else {
    dst[49 + (c - 28)] = tot;  // b_c (7), then the cost
  }
}

}  // namespace

// cam (lanes, O) int32; C (lanes, O, 3), q (lanes, O, 4), X (lanes, O, 3),
// uv (lanes, O, 2), w (lanes, O) f32 -> dtd (lanes, O, 9), wblk (lanes, O,
// 21), bp (lanes, O, 3), cam_out (lanes, V, 57): each lane as its own launch
// (4 | O when lanes > 1, which keeps every lane's rows 16-byte aligned).
// Scratch: rows holds lanes * ceil(O / 128) * rmax * 36 floats with rmax =
// min(128, V); slot holds lanes * V * ceil(O / 128) bytes. Observations whose
// camera id is outside [0, V) enter no camera sum.
extern "C" int sfm_ba_blocks_lanes(const int* cam, const float* C, const float* q,
                                   const float* X, const float* uv, const float* w,
                                   int lanes, int O, int V, float huber, float* dtd,
                                   float* wblk, float* bp, float* rows, unsigned char* slot,
                                   float* cam_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (O + kBO - 1) / kBO;
  const int rmax = V < kBO ? V : kBO;
  if (nb <= 0 || V <= 0 || V > kNoKey || lanes < 1 || lanes > 65535 || (lanes > 1 && O % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  ba_assemble<<<dim3(nb, lanes), kBO, 0, s>>>(cam, C, q, X, uv, w, O, V, huber, dtd, wblk,
                                              bp, rows, slot, rmax);
  ba_reduce_rows<<<dim3(V, lanes), kP * kGroups, 0, s>>>(rows, slot, nb, V, rmax, cam_out);
  return static_cast<int>(cudaGetLastError());
}
