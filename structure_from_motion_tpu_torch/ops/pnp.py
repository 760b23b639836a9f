"""Perspective-n-Point: batched 6-point DLT RANSAC + LM refinement (port of
``structure_from_motion_tpu/ops/pnp.py``).

The DLT takes its null vector and rotation from the SVD on every device
(the JAX package's CPU path; on the H100, cuSOLVER's batched SVD is both
faster and more accurate than its accelerator path, gram inverse iteration
plus a Newton polar factor). RANSAC samples are inputs of :func:`linear_pnp_ransac` (see :func:`sample_pnp`);
the LM loops keep the JAX package's early exit once the squared step
falls below 1e-14.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_from_motion_tpu_torch.config import LMConfig, RansacConfig
from structure_from_motion_tpu_torch.device import stable_topk
from structure_from_motion_tpu_torch.ops.linalg import (
    det3x3,
    nullspace,
)
from structure_from_motion_tpu_torch.ops.ransac import ransac, sample_index_sets
from structure_from_motion_tpu_torch.ops.reproj import batched_residual_jacobians, pixel_residuals
from structure_from_motion_tpu_torch.utils.geometry import normalized_camera_coords
from structure_from_motion_tpu_torch.utils.rotations import (
    quat_normalize,
    quat_to_rotation,
    rotation_to_quat,
)


class PnPResult(NamedTuple):
    R: torch.Tensor  # (3, 3) cam-to-world rotation
    C: torch.Tensor  # (3,) camera centre
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int


def solve_pnp_dlt(X, meas_norm, weights=None):
    """Weighted N-point DLT pose (N >= 6) in normalised coordinates;
    batched over leading axes. Returns cam-to-world (R, C); the global sign
    is fixed by a majority positive-depth vote."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    u = meas_norm[..., 0:1]
    v = meas_norm[..., 1:2]
    zeros = torch.zeros_like(Xh)
    row1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    row2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    W = torch.cat([row1, row2], dim=-2)
    if weights is not None:
        W = W * torch.cat([weights, weights], dim=-1)[..., None]
    P = nullspace(W).reshape(*W.shape[:-2], 3, 4)
    A, b = P[..., :3], P[..., 3]
    uu, s, vh = torch.linalg.svd(A)
    R_w2c, s0 = uu @ vh, s[..., 0]
    det = det3x3(R_w2c)
    R_w2c = R_w2c * det[..., None, None]
    t = det[..., None] * b / s0.clamp_min(1e-12)[..., None]
    Xc = torch.einsum("...ij,...nj->...ni", R_w2c, X) + t[..., None, :]
    votes = torch.sign(Xc[..., 2])
    if weights is not None:
        votes = votes * weights
    flip = torch.where(votes.sum(-1) < 0, -1.0, 1.0).to(t.dtype)
    t = t * flip[..., None]
    R = R_w2c.transpose(-1, -2)
    return R, -torch.einsum("...ij,...j->...i", R, t)


def _lm_steps(q, C, X, meas_norm, mask, iterations: int, damping: float, huber_delta=0.0):
    """LM iterations on [C, q] over the masked observations, stopping once
    the squared step is <= 1e-14. ``huber_delta`` (float or 0-dim tensor,
    normalised units) > 0 turns on IRLS Huber reweighting."""
    m = mask.to(X.dtype)
    eye = torch.eye(7, dtype=X.dtype, device=X.device)
    n = X.shape[0]
    robust = not (isinstance(huber_delta, (int, float)) and huber_delta <= 0.0)
    for _ in range(iterations):
        res, J_cam, _ = batched_residual_jacobians(C.expand(n, 3), q.expand(n, 4), X, meas_norm)
        mm = m
        if robust:
            delta_h = torch.as_tensor(huber_delta, dtype=X.dtype, device=X.device)
            nrm = torch.linalg.norm(res, dim=-1)
            hw = torch.sqrt(torch.where(nrm <= delta_h, torch.ones_like(nrm),
                                        delta_h / nrm.clamp_min(1e-12)))
            mm = m * torch.where(delta_h > 0, hw, torch.ones_like(hw))
        res = res * mm[:, None]
        J = (J_cam * mm[:, None, None]).reshape(-1, 7)
        delta = torch.linalg.solve_ex(J.T @ J + damping * eye, J.T @ res.reshape(-1))[0]
        C = C + delta[:3]
        q = quat_normalize(q + delta[3:])
        if not float((delta * delta).sum()) > 1e-14:
            break
    return q, C


def sample_pnp(gen: torch.Generator, mask: torch.Tensor, config: RansacConfig):
    """(idx_sets (H, s), scoring subset (score_subset,) or None) drawn from
    ``gen`` for :func:`linear_pnp_ransac`."""
    n = mask.shape[0]
    sub = None
    if 0 < config.score_subset < n:
        u = torch.rand(n, generator=gen, device=mask.device)
        u = torch.where(mask, u, torch.full_like(u, float("-inf")))
        sub = stable_topk(u, config.score_subset)[1]
    idx_sets = sample_index_sets(gen, mask, config.num_hypotheses, config.sample_num)
    return idx_sets, sub


def linear_pnp_ransac(idx_sets, X, uv, K, mask, config: RansacConfig, sub=None) -> PnPResult:
    """RANSAC linear PnP over given 6-point index sets (H, 6). With
    ``0 < config.score_subset < N`` hypotheses are ranked on the valid
    subset ``sub`` and the winner re-scored on the full set. Three LO rounds
    (weighted DLT refit -> 10-step LM polish -> re-score) follow; their
    result is kept when it holds at least as many inliers."""
    meas_norm = normalized_camera_coords(K, uv)
    thr2 = config.inlier_threshold**2
    idx_sets = idx_sets.long()

    def fit(idx):
        R, C = solve_pnp_dlt(X[idx], meas_norm[idx])
        return rotation_to_quat(R), C

    def inlier_matrix(qs, Cs, Xp, uvp):
        res, _ = pixel_residuals(K, Cs[:, None, :], qs[:, None, :], Xp[None], uvp[None])
        return (res * res).sum(-1) < thr2

    n = X.shape[0]
    if 0 < config.score_subset < n:
        if sub is None:
            raise ValueError("linear_pnp_ransac: score_subset needs the subset indices")
        qs, Cs = fit(idx_sets)
        inl_sub = inlier_matrix(qs, Cs, X[sub], uv[sub]) & mask[sub][None]
        best = torch.argmax(inl_sub.sum(1))
        q_best, C_best = qs[best], Cs[best]
        inliers = inlier_matrix(q_best[None], C_best[None], X, uv)[0] & mask
    else:
        res = ransac(idx_sets, mask, fit, lambda models: inlier_matrix(*models, X, uv))
        (q_best, C_best), inliers = res.model, res.inliers
    n_best = inliers.sum()

    q, C, inl = q_best, C_best, inliers
    for _ in range(3):  # LO rounds
        R_refit, C_refit = solve_pnp_dlt(X, meas_norm, weights=inl.to(X.dtype))
        q, C = _lm_steps(rotation_to_quat(R_refit), C_refit, X, meas_norm, inl,
                         iterations=10, damping=1e-3)
        res_pix, _ = pixel_residuals(K, C, q, X, uv)
        inl = (torch.linalg.norm(res_pix, dim=-1) < config.inlier_threshold) & mask
    better = inl.sum() >= n_best
    q_best = torch.where(better, q, q_best)
    C_best = torch.where(better, C, C_best)
    inliers = torch.where(better, inl, inliers)
    return PnPResult(R=quat_to_rotation(q_best), C=C_best, inliers=inliers,
                     num_inliers=inliers.sum())


def refine_pnp(X, uv, K, mask, R0, C0, config: LMConfig):
    """Fixed-damping LM refinement of one pose (normalised-coordinate
    residuals); returns (R, C)."""
    q, C = _lm_steps(rotation_to_quat(R0), C0, X, normalized_camera_coords(K, uv), mask,
                     iterations=config.iterations, damping=config.damping)
    return quat_to_rotation(q), C


def estimate_pnp(gen, X, uv, K, mask, ransac_config: RansacConfig, lm_config: LMConfig,
                 prior_R=None, prior_C=None) -> PnPResult:
    """Linear RANSAC -> (with a motion prior) a Huber-IRLS LM candidate from
    the prior, the one with more pixel inliers winning -> 25-step polish on
    the winner's inliers -> :func:`refine_pnp`."""
    idx_sets, sub = sample_pnp(gen, mask, ransac_config)
    lin = linear_pnp_ransac(idx_sets, X, uv, K, mask, ransac_config, sub)
    inliers, num_inliers, R0, C0 = lin.inliers, lin.num_inliers, lin.R, lin.C
    meas_norm = normalized_camera_coords(K, uv)
    if prior_R is not None:
        delta_n = ransac_config.inlier_threshold / K[..., 0, 0]
        q_p, C_p = _lm_steps(rotation_to_quat(prior_R), prior_C, X, meas_norm, mask,
                             iterations=lm_config.iterations, damping=5.0, huber_delta=delta_n)
        res_pix, depth = pixel_residuals(K, C_p, q_p, X, uv)
        inl_p = (torch.linalg.norm(res_pix, dim=-1) < ransac_config.inlier_threshold) \
            & (depth > 0) & mask
        n_p = inl_p.sum()
        use_p = n_p > num_inliers
        R0 = torch.where(use_p, quat_to_rotation(q_p), R0)
        C0 = torch.where(use_p, C_p, C0)
        inliers = torch.where(use_p, inl_p, inliers)
        num_inliers = torch.where(use_p, n_p, num_inliers)
    q0, C0 = _lm_steps(rotation_to_quat(R0), C0, X, meas_norm, inliers, iterations=25, damping=1e-3)
    R, C = refine_pnp(X, uv, K, inliers, quat_to_rotation(q0), C0, lm_config)
    return PnPResult(R=R, C=C, inliers=inliers, num_inliers=num_inliers)
