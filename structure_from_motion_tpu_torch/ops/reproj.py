"""Reprojection residuals + closed-form Jacobians (port of
``structure_from_motion_tpu/ops/reproj.py``).

Residuals in normalised camera coordinates for a camera ``[C (3), q (4)]``;
d vec(R)/d q is the raw (unnormalised) quadratic form; residual sign is
``measurement - projection``. With per-observation intrinsics ``(f, k1,
k2)`` the camera block is ``[C, q, f, k1, k2]`` (Snavely's BAL model,
principal point at 0): residuals in pixels through ``f (1 + k1 rho^2 + k2
rho^4)`` of the normalised point, ``rho^2 = u^2 + v^2``.
"""

from __future__ import annotations

import torch

from structure_from_motion_tpu_torch.utils.rotations import (
    drotation_dquat,
    quat_to_rotation,
)


def _safe_depth(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)


def project_normalized(C: torch.Tensor, q: torch.Tensor, X: torch.Tensor):
    """World point(s) -> (normalised coords (..., 2), depth (...,)); all
    arguments broadcast."""
    R = quat_to_rotation(q)
    d = X - C
    x = (R.transpose(-1, -2) @ d[..., None])[..., 0]  # R^T d
    depth = x[..., 2]
    return x[..., :2] / _safe_depth(depth)[..., None], depth


def observation_residual_jacobians(C, q, X, meas):
    """Residual and Jacobian blocks of ONE observation: (3,), (4,), (3,),
    (2,) -> res (2,), J_cam (2, 7), J_pt (2, 3) (the batched closed form on
    a batch of one)."""
    res, J_cam, J_pt = batched_residual_jacobians(C[None], q[None], X[None], meas[None])
    return res[0], J_cam[0], J_pt[0]


def batched_residual_jacobians(C, q, X, meas, intr=None):
    """(O,3),(O,4),(O,3),(O,2) -> res (O,2), J_cam (O,2,7), J_pt (O,2,3);
    with ``intr`` (O,3) = (f, k1, k2), ``meas`` in pixels, res in pixels and
    J_cam (O,2,10)."""
    R = quat_to_rotation(q)  # (O, 3, 3)
    d = X - C
    x = torch.einsum("oji,oj->oi", R, d)  # R^T d
    z = _safe_depth(x[..., 2])
    u = x[..., 0] / z
    v = x[..., 1] / z
    res = meas - torch.stack([u, v], dim=-1)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    dproj_dx = torch.stack(
        [torch.stack([one, zero, -u], dim=-1), torch.stack([zero, one, -v], dim=-1)],
        dim=-2,
    ) / z[..., None, None]  # (O, 2, 3)
    dproj_dX = torch.einsum("oik,ojk->oij", dproj_dx, R)  # dx/dX = R^T
    dRdq = drotation_dquat(q).reshape(*q.shape[:-1], 3, 3, 4)
    dx_dq = torch.einsum("ojik,oj->oik", dRdq, d)  # (O, 3, 4)
    dproj_dq = torch.einsum("oik,okl->oil", dproj_dx, dx_dq)  # (O, 2, 4)
    J_cam = torch.cat([-dproj_dX, dproj_dq], dim=-1)
    if intr is None:
        return res, J_cam, dproj_dX
    # pixels: proj = s (u, v), s = f (1 + k1 rho^2 + k2 rho^4); d proj / d (u, v)
    # = s I + g (u, v)^T (u, v), g = f (2 k1 + 4 k2 rho^2)
    f, k1, k2 = intr.unbind(-1)
    uv = torch.stack([u, v], dim=-1)
    rho2 = u * u + v * v
    rad = 1.0 + rho2 * (k1 + k2 * rho2)
    s = f * rad
    g = f * (2.0 * k1 + 4.0 * k2 * rho2)
    A = s[..., None, None] * torch.eye(2, dtype=u.dtype, device=u.device) \
        + g[..., None, None] * uv[..., :, None] * uv[..., None, :]
    J_intr = torch.stack([rad[..., None] * uv, (f * rho2)[..., None] * uv,
                          (f * rho2 * rho2)[..., None] * uv], dim=-1)  # (O, 2, 3)
    J_pt = A @ dproj_dX
    return meas - s[..., None] * uv, torch.cat([A @ J_cam, J_intr], dim=-1), J_pt


def pixel_residuals(K, C, q, X, uv):
    """Pixel residuals (meas - proj) and depths; broadcasts over leading axes."""
    proj_n, depth = project_normalized(C, q, X)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    px = torch.stack([proj_n[..., 0] * fx + cx, proj_n[..., 1] * fy + cy], dim=-1)
    return uv - px, depth
