"""Rotation / quaternion kit (port of ``structure_from_motion_tpu/utils/rotations.py``).

Batched over leading axes, branch-free. Quaternions are ``(w, x, y, z)``.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalise quaternions to unit length over the last axis."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) ``(..., 4)`` -> rotation matrix(es) ``(..., 3, 3)``."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix(es) ``(..., 3, 3)`` -> unit quaternion(s) ``(..., 4)``
    by Shepperd's largest-pivot selection; sign fixed to ``w >= 0``."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    tw = 1.0 + tr
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(v.clamp_min(1e-24))

    sw, sx, sy, sz = safe_sqrt(tw), safe_sqrt(tx), safe_sqrt(ty), safe_sqrt(tz)
    qw = torch.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz], dim=-1)
    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return torch.where(q[..., :1] < 0, -q, q)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: ``(..., 3)`` -> skew-symmetric ``(..., 3, 3)``."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w.unbind(-1)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues exponential map ``(..., 3)`` -> ``(..., 3, 3)``."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True).clamp_min(eps)
    K = so3_hat(w / theta)
    theta = theta[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)


def drotation_dquat(q: torch.Tensor) -> torch.Tensor:
    """Analytic 9x4 Jacobian d vec(R)/d q of an (unnormalised) quaternion,
    row-major vec(R)."""
    w, x, y, z = (2.0 * c for c in q.unbind(-1))
    rows = [
        [w, x, -y, -z],  # R00
        [-z, y, x, -w],  # R01
        [y, z, w, x],  # R02
        [z, y, x, w],  # R10
        [w, -x, y, -z],  # R11
        [-x, -w, z, y],  # R12
        [-y, z, -w, x],  # R20
        [x, w, z, y],  # R21
        [w, -x, -y, z],  # R22
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions, batched."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def rotation_is_valid(R: torch.Tensor, tol: float = 1e-3) -> torch.Tensor:
    """det(R) ~ 1 and R R^T ~ I, within ``tol``, for (..., 3, 3) batches."""
    det_ok = (torch.linalg.det(R) - 1.0).abs() < tol
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    orth_ok = (R @ R.transpose(-1, -2) - eye).abs().amax(dim=(-2, -1)) < tol
    return det_ok & orth_ok
