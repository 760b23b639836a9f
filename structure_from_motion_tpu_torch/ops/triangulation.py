"""Batched triangulation: linear DLT + fixed-damping LM (port of
``structure_from_motion_tpu/ops/triangulation.py``).

The DLT null vector comes from an SVD on every device (the JAX package's
CPU path; kernel B7 on the card, see ``ops/pnp.py``); the LM loop
has the JAX package's early exit once the largest squared step falls below
1e-14, stopped on the device (``utils/control.masked_loop``, one host read
every ``pnp.LM_CHUNK`` steps, each chunk one CUDA graph replay on the card).
"""

from __future__ import annotations

import functools

import torch

from structure_from_motion_tpu_torch.config import LMConfig
from structure_from_motion_tpu_torch.ops.linalg import (
    floor_abs,
    inv3x3,
    nullspace,
)
from structure_from_motion_tpu_torch.ops.pnp import LM_CHUNK
from structure_from_motion_tpu_torch.utils.control import masked_loop


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


def _lm_body(active, X, P, uv, obs_mask, lam: float):
    """One LM step of every point of an active lane; any other lane's
    points keep their iterate."""
    res, _ = reprojection_residuals(P, X, uv, obs_mask)
    J = _projection_jacobian(P, X, obs_mask)
    Jf = J.reshape(J.shape[0], -1, 3)
    rf = res.reshape(res.shape[0], -1)
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    JtJ = torch.einsum("nki,nkj->nij", Jf, Jf) + lam * eye
    Jte = torch.einsum("nki,nk->ni", Jf, rf)
    delta = torch.einsum("nij,nj->ni", inv3x3(JtJ), Jte)
    lanes = active.shape[0]
    Xl = X.view(lanes, -1, 3)
    X = torch.where(active[:, None, None], Xl - delta.reshape(lanes, -1, 3), Xl).view(X.shape)
    return active & ((delta * delta).sum(-1).view(lanes, -1).amax(1) > 1e-14), X


def refine_triangulate(P, uv, obs_mask, X0_h, config: LMConfig, lanes: int = 0) -> torch.Tensor:
    """Fixed-damping LM over all points at once -> refined (N, 4), W = 1.

    The points are ``max(lanes, 1)`` equal runs, one a lane of the batched
    engine, each stopping on its own (its largest squared step <= 1e-14)
    and then keeping its iterate; the loop
    (:func:`~..utils.control.masked_loop`) ends when every lane has
    stopped, so each lane gets what a call on its run alone gives."""
    X = X0_h[..., :3] / _safe(X0_h[..., 3:4])
    if X.shape[0]:
        active = torch.ones(max(lanes, 1), dtype=torch.bool, device=X.device)
        _, X = masked_loop(config.iterations, LM_CHUNK,
                           functools.partial(_lm_body, lam=config.damping), (active, X),
                           P, uv, obs_mask)
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def triangulate(P, uv, obs_mask, config: LMConfig, lanes: int = 0) -> torch.Tensor:
    """Linear DLT then LM refinement (``lanes``: see :func:`refine_triangulate`)."""
    return refine_triangulate(P, uv, obs_mask, linear_triangulate(P, uv, obs_mask), config,
                              lanes=lanes)


def mean_reprojection_error(P, X_h, uv, obs_mask) -> torch.Tensor:
    """Mean pixel reprojection error over the valid observations of
    homogeneous points ``X_h`` (N, 4)."""
    X = X_h[..., :3] / _safe(X_h[..., 3:4])
    res, _ = reprojection_residuals(P, X, uv, obs_mask)
    return torch.linalg.norm(res, dim=-1).sum() / obs_mask.sum().clamp_min(1)
