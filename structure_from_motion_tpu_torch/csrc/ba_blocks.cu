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
// What bounds it on an H100: device-memory bandwidth for the per-observation
// stream (~60 bytes in, 132 bytes of blocks out, for ~400 FLOPs of closed
// form math) and, in the camera reduction, shared-memory traffic.
//
// What the design does about it: one thread per observation does the whole
// closed form in registers and writes DtD, W and b_p row-major as (O, 9),
// (O, 21), (O, 3). The 57-wide camera payload [Jc^T Jc (49) | Jc^T r (7) |
// r^2 (1)] never leaves the chip per observation: each block parks its 128
// payloads in shared memory and reduces them per camera into a
// (num_blocks, V, 57) partial table, which a second small kernel sums over
// blocks in a fixed order. The TPU kernel carried the camera sum across its
// sequential grid; Hopper's blocks run in no order, and atomics would make
// the sums differ run to run, so there are none: the result is
// deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kBO = 128;  // observations per block
constexpr int kP = 57;    // camera payload width

__global__ void __launch_bounds__(kBO)
ba_assemble(const int* __restrict__ cam, const float* __restrict__ Cg,
            const float* __restrict__ qg, const float* __restrict__ Xg,
            const float* __restrict__ uvg, const float* __restrict__ wg, int O,
            int V, float huber, float* __restrict__ dtd_out,
            float* __restrict__ wblk_out, float* __restrict__ bp_out,
            float* __restrict__ partial) {
  __shared__ float pay[kBO * kP];
  __shared__ int cs[kBO];
  const int t = threadIdx.x;
  const int o = blockIdx.x * kBO + t;
  if (o < O) {
    const float C0 = Cg[3 * o], C1 = Cg[3 * o + 1], C2 = Cg[3 * o + 2];
    const float qw = qg[4 * o], qx = qg[4 * o + 1], qy = qg[4 * o + 2],
                qz = qg[4 * o + 3];
    const float X0 = Xg[3 * o], X1 = Xg[3 * o + 1], X2 = Xg[3 * o + 2];
    const float m0 = uvg[2 * o], m1 = uvg[2 * o + 1];
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

#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dtd_out[(size_t)o * 9 + 3 * i + j] = p0[i] * p0[j] + p1[i] * p1[j];
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        wblk_out[(size_t)o * 21 + 3 * i + j] = row0[i] * p0[j] + row1[i] * p1[j];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      bp_out[(size_t)o * 3 + j] = p0[j] * res0 + p1[j] * res1;

    float* my = pay + t * kP;
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int j = 0; j < 7; ++j) my[7 * i + j] = row0[i] * row0[j] + row1[i] * row1[j];
#pragma unroll
    for (int i = 0; i < 7; ++i) my[49 + i] = row0[i] * res0 + row1[i] * res1;
    my[56] = res0 * res0 + res1 * res1;
    cs[t] = cam[o];
  } else {
    cs[t] = -1;
  }
  __syncthreads();
  // per-camera sums over this block's observations, in observation order
  for (int idx = t; idx < V * kP; idx += kBO) {
    const int vv = idx / kP, c = idx - vv * kP;
    float acc = 0.f;
    for (int k = 0; k < kBO; ++k)
      if (cs[k] == vv) acc += pay[k * kP + c];
    partial[((size_t)blockIdx.x * V + vv) * kP + c] = acc;
  }
}

__global__ void ba_reduce_blocks(const float* __restrict__ partial, int nb,
                                 int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int b = 0; b < nb; ++b) acc += partial[(size_t)b * n + i];
  out[i] = acc;
}

}  // namespace

// cam (O,) int32; C (O, 3), q (O, 4), X (O, 3), uv (O, 2), w (O,) f32 ->
// dtd (O, 9), wblk (O, 21), bp (O, 3), cam_out (V, 57); partial is scratch of
// ceil(O / 128) * V * 57 floats. Observations whose camera id is outside
// [0, V) enter no camera sum.
extern "C" int sfm_ba_blocks(const int* cam, const float* C, const float* q,
                             const float* X, const float* uv, const float* w,
                             int O, int V, float huber, float* dtd, float* wblk,
                             float* bp, float* partial, float* cam_out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (O + kBO - 1) / kBO;
  if (nb > 0)
    ba_assemble<<<nb, kBO, 0, s>>>(cam, C, q, X, uv, w, O, V, huber, dtd, wblk,
                                   bp, partial);
  const int n = V * kP;
  ba_reduce_blocks<<<(n + 127) / 128, 128, 0, s>>>(partial, nb, n, cam_out);
  return static_cast<int>(cudaGetLastError());
}
