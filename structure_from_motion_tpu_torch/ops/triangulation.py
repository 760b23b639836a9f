"""Batched triangulation: linear DLT + fixed-damping LM (port of
``structure_from_motion_tpu/ops/triangulation.py``).

The DLT null vector comes from the SVD on every device (the JAX package's
CPU path; see ``ops/pnp.py`` for why the card takes it too); the LM loop is
a Python loop with the JAX package's early exit once the largest squared
step falls below 1e-14.
"""

from __future__ import annotations

import torch

from structure_from_motion_tpu_torch.config import LMConfig
from structure_from_motion_tpu_torch.ops.linalg import (
    floor_abs,
    inv3x3,
    nullspace,
)


def linear_triangulate(P: torch.Tensor, uv: torch.Tensor, obs_mask: torch.Tensor) -> torch.Tensor:
    """``P`` (V, 3, 4) shared or (N, V, 3, 4) per point; ``uv`` (N, V, 2);
    ``obs_mask`` (N, V) -> homogeneous points (N, 4) with W = 1."""
    if P.dim() == 3:
        P = P[None]
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    rows = torch.cat([u * P[..., 2, :] - P[..., 0, :], v * P[..., 2, :] - P[..., 1, :]], dim=1)
    m = torch.cat([obs_mask, obs_mask], dim=1)[..., None].to(rows.dtype)
    rows = rows * m
    X = nullspace(rows)
    return X / floor_abs(X[..., 3:4], 1e-12)


def _project(P, Xh):
    if P.dim() == 3:
        return torch.einsum("vij,nj->nvi", P, Xh)
    return torch.einsum("nvij,nj->nvi", P, Xh)


def _safe(depth):
    return torch.where(depth.abs() < 1e-12, torch.full_like(depth, 1e-12), depth)


def reprojection_residuals(P, X, uv, obs_mask):
    """(proj - meas) residuals (N, V, 2), zero where masked, and depths (N, V)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    proj = _project(P, Xh)
    depth = proj[..., 2]
    pix = proj[..., :2] / _safe(depth)[..., None]
    return (pix - uv) * obs_mask[..., None].to(X.dtype), depth


def _projection_jacobian(P, X, obs_mask):
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    proj = _project(P, Xh)
    safe = _safe(proj[..., 2])
    Pb = P[None] if P.dim() == 3 else P
    A = Pb[..., :2, :3]
    c = Pb[..., 2, :3]
    pix = proj[..., :2] / safe[..., None]
    J = (A - pix[..., None] * c[..., None, :]) / safe[..., None, None]
    return J * obs_mask[..., None, None].to(X.dtype)


def refine_triangulate(P, uv, obs_mask, X0_h, config: LMConfig) -> torch.Tensor:
    """Fixed-damping LM over all points at once -> refined (N, 4), W = 1."""
    X = X0_h[..., :3] / _safe(X0_h[..., 3:4])
    lam = config.damping
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(config.iterations):
        res, _ = reprojection_residuals(P, X, uv, obs_mask)
        J = _projection_jacobian(P, X, obs_mask)
        Jf = J.reshape(J.shape[0], -1, 3)
        rf = res.reshape(res.shape[0], -1)
        JtJ = torch.einsum("nki,nkj->nij", Jf, Jf) + lam * eye
        Jte = torch.einsum("nki,nk->ni", Jf, rf)
        delta = torch.einsum("nij,nj->ni", inv3x3(JtJ), Jte)
        X = X - delta
        if X.shape[0] == 0 or not float((delta * delta).sum(-1).max()) > 1e-14:
            break
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def triangulate(P, uv, obs_mask, config: LMConfig) -> torch.Tensor:
    """Linear DLT then LM refinement."""
    return refine_triangulate(P, uv, obs_mask, linear_triangulate(P, uv, obs_mask), config)
