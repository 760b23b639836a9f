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
//   are added in group order and U is mirrored on the way out, into U, b_c
//   and the camera's cost, each an output of its own. The lane axis is a
//   template parameter of this kernel: a lane shifts the range of blocks
//   it walks (rows and slots are both indexed by lane * nb + block) and its
//   camera's output row, two integer terms and no pointer bumps. Bumping
//   the three pointers by blockIdx.y took ptxas from 32 to 64 registers a
//   thread, so the 1008-thread block fitted once an SM, not twice, and the
//   kernel ran at half speed; the one-lane instantiation has no lane term
//   at all.
//
// The camera block's width NC is a template parameter: 7 ([C, q]; the
// instantiations ba_assemble<7>, ba_reduce_rows<7, false> and <7, true>)
// and 10, the self-calibrating block [C, q, f, k1, k2] of a BAL-style
// problem (ba_assemble<10>, ba_reduce_rows<10, false>; one lane). At width
// 10 the residual is in pixels through f (1 + k1 rho^2 + k2 rho^4) with the
// principal point at 0: the normalised 2x3 and 2x7 rows are taken through
// the symmetric 2x2 d proj / d (u, v), and the three intrinsics' columns
// are closed forms. A slot then reads 68 bytes (the camera's f, k1, k2
// besides) and writes 168 (W is 10x3), and the payload is 66 wide (55 +
// 10 + 1): stage 1 gives a lane up to three payload words, and stage 2
// runs 15 groups of 66 threads (990; 28 x 66 would pass a block's 1024).
// The payload and the staging would pass 48 KB of static shared memory at
// width 10, so there the payload waits in registers until the blocks have
// left and then takes the staging's words. The width-7 instantiations keep
// the [C, q] kernel's arithmetic and the order of every sum, so its outputs
// keep their bits (tools/profile_kernels.py prints each output's sha256).
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
// Per camera width NC (7: [C, q]; 10: [C, q, f, k1, k2]): the payload is the
// upper U (28 or 55), then b_c (NC), then the cost (1): 36 or 66 floats.
template <int NC> constexpr int kU = NC * (NC + 1) / 2;
template <int NC> constexpr int kPay = kU<NC> + NC + 1;
template <int NC> constexpr int kPS = kPay<NC> + 1;  // padded payload stride (odd: 37, 67)
// stage-2 groups of kPay threads: 28 x 36 = 1008 threads, 15 x 66 = 990
template <int NC> constexpr int kGrp = NC == 7 ? 28 : 15;
// the per-camera costs lie kCostStride floats apart: torch sums a strided
// vector in one order whatever V is (a contiguous one of more than 128
// floats it vectorises, in another order)
constexpr int kCostStride = 2;
constexpr int kNoKey = 0x00ffffff;  // above every camera id; key * 128 fits an int
constexpr int kNoSlot = 255;
// per-observation output staging (words): DtD | W | b_p
template <int NC> constexpr int kOffW = kBO * 9;
template <int NC> constexpr int kOffB = kBO * (9 + 3 * NC);
template <int NC> constexpr int kStage = kBO * (12 + 3 * NC);
// At NC = 10 the payload (34.3 KB) and the staging (21.5 KB) would pass the
// 48 KB of static shared memory: the payload then takes the staging's words
// once the per-observation blocks have left, and waits in registers until
// then. At NC = 7 each has its own words.
template <int NC> constexpr bool kAlias = NC != 7;
// the words of the shared payload and staging at NC = 10
template <int NC> constexpr int kSmem =
    kBO * kPS<NC> > kStage<NC> ? kBO * kPS<NC> : kStage<NC>;

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

// One observation's payload row: the upper U, b_c, r^2.
template <int NC>
__device__ __forceinline__ void write_payload(float* my, const float* row0,
                                              const float* row1, float res0,
                                              float res1) {
  int idx = 0;
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int j = i; j < NC; ++j)
      my[idx++] = row0[i] * row0[j] + row1[i] * row1[j];
#pragma unroll
  for (int i = 0; i < NC; ++i) my[kU<NC> + i] = row0[i] * res0 + row1[i] * res1;
  my[kU<NC> + NC] = res0 * res0 + res1 * res1;
}

// Kg (O, 3): each observation's camera intrinsics (f, k1, k2), read at NC =
// 10 only (nullptr at NC = 7).
template <int NC>
__global__ void __launch_bounds__(kBO)
ba_assemble(const int* __restrict__ cam, const float* __restrict__ Cg,
            const float* __restrict__ qg, const float* __restrict__ Xg,
            const float* __restrict__ uvg, const float* __restrict__ wg,
            const float* __restrict__ Kg, int O,
            int V, float huber, float* __restrict__ dtd_out,
            float* __restrict__ wblk_out, float* __restrict__ bp_out,
            float* __restrict__ rows, unsigned char* __restrict__ slot,
            int rmax) {
  constexpr int P = kPay<NC>, PS = kPS<NC>;
  // at NC = 7 the payload and the staging are two arrays; at NC = 10 the
  // payload takes the staging's words (kAlias)
  __shared__ float pay_own[kAlias<NC> ? 1 : kBO * PS];
  __shared__ __align__(16) float so[kAlias<NC> ? kSmem<NC> : kStage<NC>];
  float* const pay = kAlias<NC> ? so : pay_own;
  __shared__ float sC[kBO * 3], sX[kBO * 3];
  __shared__ float sK[NC == 7 ? 1 : kBO * 3];
  __shared__ __align__(16) int keys[kBO];
  __shared__ int skey[kBO], order[kBO], seg_start[kBO + 1];
  __shared__ unsigned headmask[kBO / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x, nb = gridDim.x;
  {  // blockIdx.y is the lane: O observations and their scratch a lane
    const size_t lo = (size_t)blockIdx.y * O;
    cam += lo; Cg += 3 * lo; qg += 4 * lo; Xg += 3 * lo; uvg += 2 * lo; wg += lo;
    dtd_out += 9 * lo; wblk_out += 3 * NC * lo; bp_out += 3 * lo;
    rows += (size_t)blockIdx.y * nb * rmax * P;
    slot += (size_t)blockIdx.y * nb * V;
  }
  const int o0 = b * kBO;
  const int o = o0 + t;
  const int n_here = min(kBO, O - o0);

  for (int i = t; i < 3 * n_here; i += kBO) {
    sC[i] = Cg[(size_t)3 * o0 + i];
    sX[i] = Xg[(size_t)3 * o0 + i];
    if constexpr (NC == 10) sK[i] = Kg[(size_t)3 * o0 + i];
  }
  for (int v = t; v < V; v += kBO) slot[(size_t)b * V + v] = kNoSlot;
  int key = kNoKey;
  // NC = 10: the payload's inputs (row0, row1, res0, res1), held past the
  // staging's stores
  float keep[kAlias<NC> ? 2 * NC + 2 : 1];
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
    // NC = 10: pixels through the radial distortion, proj = s (u, v) with
    // s = f (1 + k1 rho^2 + k2 rho^4), so d proj / d (u, v) is the
    // symmetric A = s I + g (u, v)^T (u, v), g = f (2 k1 + 4 k2 rho^2)
    const float fo = NC == 7 ? 0.f : sK[3 * t], k1 = NC == 7 ? 0.f : sK[3 * t + 1],
                k2 = NC == 7 ? 0.f : sK[3 * t + 2];
    const float rho2 = u * u + v * v;
    const float rad = 1.f + rho2 * (k1 + k2 * rho2);
    const float s = fo * rad;
    float res0 = NC == 7 ? m0 - u : m0 - s * u, res1 = NC == 7 ? m1 - v : m1 - s * v;

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
    float row0[NC], row1[NC], p0[3], p1[3];
    if constexpr (NC == 7) {
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
    } else {
      const float g = fo * (2.f * k1 + 4.f * k2 * rho2);
      const float a00 = s + g * u * u, a01 = g * u * v, a11 = s + g * v * v;
      const float jp0[3] = {jp00, jp01, jp02}, jp1[3] = {jp10, jp11, jp12};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        p0[i] = (a00 * jp0[i] + a01 * jp1[i]) * rw;
        p1[i] = (a01 * jp0[i] + a11 * jp1[i]) * rw;
        row0[i] = -p0[i];
        row1[i] = -p1[i];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float n0 = (dx0[k] - u * dx2[k]) * inv_z;
        const float n1 = (dx1[k] - v * dx2[k]) * inv_z;
        row0[3 + k] = (a00 * n0 + a01 * n1) * rw;
        row1[3 + k] = (a01 * n0 + a11 * n1) * rw;
      }
      const float f2 = fo * rho2, f4 = fo * rho2 * rho2;
      row0[7] = rad * u * rw; row1[7] = rad * v * rw;
      row0[8] = f2 * u * rw;  row1[8] = f2 * v * rw;
      row0[9] = f4 * u * rw;  row1[9] = f4 * v * rw;
    }

    // strides 9, 21 (30: even, two-way conflicts at NC = 10), 3 and 37 / 67
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        so[t * 9 + 3 * i + j] = p0[i] * p0[j] + p1[i] * p1[j];
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        so[kOffW<NC> + t * 3 * NC + 3 * i + j] = row0[i] * p0[j] + row1[i] * p1[j];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      so[kOffB<NC> + t * 3 + j] = p0[j] * res0 + p1[j] * res1;

    if constexpr (kAlias<NC>) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        keep[i] = row0[i];
        keep[NC + i] = row1[i];
      }
      keep[2 * NC] = res0;
      keep[2 * NC + 1] = res1;
    } else {
      write_payload<NC>(pay + t * PS, row0, row1, res0, res1);
    }
  }
  keys[t] = key * kBO + t;
  __syncthreads();

  // the per-observation blocks leave in whole lines
  const bool full = n_here == kBO;
  store_block(dtd_out + (size_t)o0 * 9, so, n_here * 9, full, t);
  store_block(wblk_out + (size_t)o0 * 3 * NC, so + kOffW<NC>, n_here * 3 * NC, full, t);
  store_block(bp_out + (size_t)o0 * 3, so + kOffB<NC>, n_here * 3, full, t);
  if constexpr (kAlias<NC>) {  // the payload takes the staging's words now
    __syncthreads();
    if (o < O) write_payload<NC>(pay + t * PS, keep, keep + NC, keep[2 * NC], keep[2 * NC + 1]);
  }

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
  constexpr int kChunks = (P + 31) / 32;  // 2 or 3 words a lane
  for (int s = warp; s < nseg; s += kBO / 32) {
    const int p0 = seg_start[s], p1 = seg_start[s + 1];
    if (skey[p0] == kNoKey) continue;  // warp-uniform
    float a[kChunks];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) a[ch] = 0.f;
    for (int p = p0; p < p1; ++p) {
      const float* src = pay + order[p] * PS;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
        if (ch == 0 || 32 * ch + lane < P) a[ch] += src[32 * ch + lane];
    }
    float* r = rows + ((size_t)b * rmax + s) * P;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
      if (ch == 0 || 32 * ch + lane < P) r[32 * ch + lane] = a[ch];
  }
}

// One block per camera: group g of kP threads walks blocks
// [g * chunk, (g + 1) * chunk) in order; the groups' sums are added in
// group order; the upper triangle of U is mirrored on the way out. With
// kLanes, blockIdx.y is the lane: its blocks are lane * nb + [0, nb) of
// the scratch, its cameras lane * V + [0, V) of the outputs.
template <int NC, bool kLanes>
__global__ void __launch_bounds__(kPay<NC> * kGrp<NC>)
ba_reduce_rows(const float* __restrict__ rows,
               const unsigned char* __restrict__ slot, int nb, int V,
               int rmax, float* __restrict__ U, float* __restrict__ bc,
               float* __restrict__ cost) {
  constexpr int kP = kPay<NC>, kGroups = kGrp<NC>;
  __shared__ float part[kGroups * kP];
  const int lb = kLanes ? blockIdx.y * nb : 0;  // the lane's first block
  const int v = blockIdx.x;
  const int c = threadIdx.x % kP, g = threadIdx.x / kP;
  const int chunk = (nb + kGroups - 1) / kGroups;
  const int b0 = lb + g * chunk, b1 = lb + min(nb, g * chunk + chunk);
  const unsigned char* sv = slot + v;  // slot[b * V + v]
  float acc = 0.f;
  // row loads a thread keeps in flight: the lane launch (128 blocks at B =
  // 8, V = 16) gains from more, the one-lane launch at V = 500 from fewer
  // (tools/kernel_variants.py --only b4); the sum's order is the same
  constexpr int kInFlight = kLanes ? 16 : 4;
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
  const size_t ov = kLanes ? (size_t)blockIdx.y * V + v : (size_t)v;  // the output row
  if (c < kU<NC>) {
    int i = 0, rem = c;
    while (rem >= NC - i) {
      rem -= NC - i;
      ++i;
    }
    const int j = i + rem;
    U[ov * NC * NC + NC * i + j] = tot;
    U[ov * NC * NC + NC * j + i] = tot;
  } else if (c < kU<NC> + NC) {
    bc[ov * NC + (c - kU<NC>)] = tot;
  } else {
    cost[ov * kCostStride] = tot;
  }
}

// the two stages of one launch at width NC
template <int NC>
int launch_blocks(const int* cam, const float* C, const float* q, const float* X,
                  const float* uv, const float* w, const float* K, int lanes, int O,
                  int V, float huber, float* dtd, float* wblk, float* bp, float* rows,
                  unsigned char* slot, float* U, float* bc, float* cost,
                  cudaStream_t s) {
  const int nb = (O + kBO - 1) / kBO;
  const int rmax = V < kBO ? V : kBO;
  if (nb <= 0 || V <= 0 || V > kNoKey || lanes < 1 || lanes > 65535 || (lanes > 1 && O % 4) ||
      (long long)lanes * nb >= (1LL << 31) || (long long)lanes * V >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  ba_assemble<NC><<<dim3(nb, lanes), kBO, 0, s>>>(cam, C, q, X, uv, w, K, O, V, huber, dtd,
                                                  wblk, bp, rows, slot, rmax);
  constexpr int threads = kPay<NC> * kGrp<NC>;
  if (lanes == 1)
    ba_reduce_rows<NC, false><<<V, threads, 0, s>>>(rows, slot, nb, V, rmax, U, bc, cost);
  else
    ba_reduce_rows<NC, true><<<dim3(V, lanes), threads, 0, s>>>(rows, slot, nb, V, rmax, U,
                                                                 bc, cost);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cam (lanes, O) int32; C (lanes, O, 3), q (lanes, O, 4), X (lanes, O, 3),
// uv (lanes, O, 2), w (lanes, O) f32 -> dtd (lanes, O, 9), wblk (lanes, O,
// 21), bp (lanes, O, 3), U (lanes, V, 7, 7), bc (lanes, V, 7), cost (lanes,
// V, 2: each camera's share at [.., 0]): each lane as its own launch (4 | O when lanes > 1, which keeps every
// lane's rows 16-byte aligned). Scratch: rows holds lanes * ceil(O / 128) *
// rmax * 36 floats with rmax = min(128, V); slot holds lanes * V *
// ceil(O / 128) bytes. Observations whose camera id is outside [0, V)
// enter no camera sum. With K (O, 3), each observation's camera's (f, k1,
// k2), the camera block is the self-calibrating [C, q, f, k1, k2] (width
// 10, one lane, uv in pixels, principal point at 0): wblk (O, 30), U (V,
// 10, 10), bc (V, 10), and rows holds ceil(O / 128) * rmax * 66 floats; K
// null gives the [C, q] block.
extern "C" int sfm_ba_blocks_lanes(const int* cam, const float* C, const float* q,
                                   const float* X, const float* uv, const float* w,
                                   const float* K, int lanes, int O, int V, float huber,
                                   float* dtd, float* wblk, float* bp, float* rows,
                                   unsigned char* slot, float* U, float* bc, float* cost,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == nullptr)
    return launch_blocks<7>(cam, C, q, X, uv, w, nullptr, lanes, O, V, huber, dtd, wblk, bp,
                            rows, slot, U, bc, cost, s);
  if (lanes != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_blocks<10>(cam, C, q, X, uv, w, K, 1, O, V, huber, dtd, wblk, bp, rows, slot,
                           U, bc, cost, s);
}
