"""Relative pose from E + cheirality disambiguation (port of
``structure_from_motion_tpu/ops/campose.py``). Same conventions: candidates
(Ra,+t), (Ra,-t), (Rb,+t), (Rb,-t) as cam-to-world rotations with centres
C = -R t."""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from structure_from_motion_tpu_torch.utils.control import fori, lane_map, take
from structure_from_motion_tpu_torch.utils.geometry import camera_extrinsic
from structure_from_motion_tpu_torch.utils.rotations import so3_exp, so3_hat


class PoseCandidates(NamedTuple):
    R: torch.Tensor  # (4, 3, 3) cam-to-world rotations
    C: torch.Tensor  # (4, 3) camera centres
    t: torch.Tensor  # (4, 3) unit translations (cam-2 frame)


def decompose_essential(E: torch.Tensor) -> PoseCandidates:
    """Four (R, C) candidates from an essential matrix."""
    # [[0, -1, 0], [1, 0, 0], [0, 0, 1]] by device ops (no upload, so an
    # exported branch can hold it; 0 - x keeps every zero +0)
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    W = torch.stack([0.0 - eye[1], eye[0], eye[2]])
    u, _, vh = torch.linalg.svd(E)
    t = u[:, 2]
    Ra = u @ W @ vh
    Rb = u @ W.T @ vh
    Ra = torch.where(torch.linalg.det(Ra) < 0, -Ra, Ra)
    Rb = torch.where(torch.linalg.det(Rb) < 0, -Rb, Rb)
    R = torch.stack([Ra.T, Ra.T, Rb.T, Rb.T])
    ts = torch.stack([t, -t, t, -t])
    C = -torch.einsum("cij,cj->ci", R, ts)
    return PoseCandidates(R=R, C=C, t=ts)


def candidate_projections(K: torch.Tensor, cands: PoseCandidates) -> torch.Tensor:
    """(4, 3, 4) projections K [R^T | -R^T C] of the candidates."""
    return K @ camera_extrinsic(cands.R, cands.C)


def cheirality_mask(P1, P2, X_h, mask):
    """Points (N, 4) with positive projective depth in both cameras."""
    d1 = X_h @ P1[2]
    d2 = X_h @ P2[2]
    return (d1 > 0) & (d2 > 0) & mask


def disambiguate_poses(P_ref, P_cands, X_cands_h, mask):
    """(best index, per-candidate counts (4,), winner's valid mask): the first
    candidate with the most points in front of both cameras."""
    valid = torch.stack(
        [cheirality_mask(P_ref, P_cands[i], X_cands_h[i], mask) for i in range(4)]
    )
    counts = valid.sum(1)
    best = torch.argmax(counts)
    return best, counts, take(valid, best)


def _pose_step(R, t, x1h, x2h, m, damping: float):
    """One Gauss-Newton step of :func:`refine_relative_pose` on one problem."""
    dt, dev = R.dtype, R.device
    eye = torch.eye(3, dtype=dt, device=dev)
    z_axis, x_axis = eye[2], eye[0]
    gens = so3_hat(eye)  # (3, 3, 3): [e_k]x

    def tangent_basis(tt):
        up = torch.where(tt[2].abs() < 0.9, z_axis, x_axis)
        e1 = torch.linalg.cross(tt, up)
        e1 = e1 / torch.linalg.norm(e1).clamp_min(1e-12)
        return e1, torch.linalg.cross(tt, e1)

    e1, e2 = tangent_basis(t)
    R_w2c = R.T
    tx = so3_hat(t)
    E = tx @ R_w2c
    # dE/dp: rotation (R0 [e_k]x)^T = -[e_k]x R0^T, then the two tangents
    dE = torch.cat([
        -(tx @ gens @ R_w2c),
        torch.stack([so3_hat(e1) @ R_w2c, so3_hat(e2) @ R_w2c]),
    ])  # (5, 3, 3)
    Ex1 = x1h @ E.T  # (N, 3)
    Etx2 = x2h @ E
    dEx1 = x1h @ dE.transpose(-1, -2)  # (5, N, 3)
    dEtx2 = x2h @ dE
    num = (x2h * Ex1).sum(1)
    dnum = (x2h * dEx1).sum(-1)  # (5, N)
    a = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    da = 2.0 * (Ex1[:, 0] * dEx1[..., 0] + Ex1[:, 1] * dEx1[..., 1]
                + Etx2[:, 0] * dEtx2[..., 0] + Etx2[:, 1] * dEtx2[..., 1])
    den = torch.sqrt(a.clamp_min(1e-18))
    dden = torch.where(a > 1e-18, da / (2.0 * den), torch.zeros_like(da))
    r = (num / den) * m
    J = ((dnum * den - num * dden) / (den * den) * m).T  # (N, 5)
    eye5 = torch.eye(5, dtype=dt, device=dev)
    p = -torch.linalg.solve_ex(J.T @ J + damping * eye5, J.T @ r)[0]
    R = R @ so3_exp(p[:3])
    t = t + p[3] * e1 + p[4] * e2
    return R, t / torch.linalg.norm(t).clamp_min(1e-12)


def _centre(R, t):
    return -R @ t


def refine_relative_pose(R, t, x1n, x2n, mask, iterations: int = 20, damping: float = 1e-6,
                         lanes: bool = False):
    """Gauss-Newton on the Sampson error of E = [t]x R_w2c over 5 dof (so(3)
    on R, a 2-dof tangent on the unit sphere at t). Returns (R, t, C = -R t).

    The JAX package takes the (N, 5) Jacobian at p = 0 by forward-mode
    differentiation of the residuals; here it is written out. At p = 0 the
    local update R0 (I + [p]x + [p]x^2 / 2) gives dR_w2c/dp_k =
    -[e_k]x R_w2c, and the tangent basis at the unit t gives dt/dp_{3,4} =
    e1, e2; so dE/dp is five 3x3 matrices, and the residual
    r = m * num / den differentiates by the quotient rule. With ``lanes``
    every input has a leading lane axis, one problem a lane. The iterations
    are a :func:`~..utils.control.fori` (the JAX package's ``fori_loop``)."""
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp_min(1e-12)
    x1h = torch.cat([x1n, torch.ones_like(x1n[..., :1])], dim=-1)
    x2h = torch.cat([x2n, torch.ones_like(x2n[..., :1])], dim=-1)
    step = functools.partial(_pose_step, damping=damping)
    centre = _centre
    if lanes:  # a leading lane axis: one problem a lane (the step vmapped)
        step, centre = functools.partial(lane_map, step), functools.partial(lane_map, centre)
    R, t = fori(iterations, lambda i, R, t, *rest: step(R, t, *rest), (R, t), x1h, x2h,
                mask.to(R.dtype))
    return R, t, centre(R, t)
