"""Perspective-n-Point: batched 6-point DLT RANSAC + LM refinement (port of
``structure_from_motion_tpu/ops/pnp.py``).

The DLT takes its null vector and rotation from an SVD on every device
(the JAX package's CPU path): kernel B7 on the card (``ops/small_svd.py``,
one-sided Jacobi on the system itself, no host read), ``torch.linalg.svd``
on the CPU; both more accurate than the JAX package's accelerator path,
gram inverse iteration plus a Newton polar factor. RANSAC samples are
inputs of :func:`linear_pnp_ransac` (see :func:`sample_pnp`);
the LM loops keep the JAX package's early exit once the squared step
falls below 1e-14, stopped on the device (``utils/control.masked_loop``:
one host read every :data:`LM_CHUNK` steps, each chunk one CUDA graph
replay on the card).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from structure_from_motion_tpu_torch.config import LMConfig, RansacConfig
from structure_from_motion_tpu_torch.device import stable_topk
from structure_from_motion_tpu_torch.ops.linalg import (
    det3x3,
    nullspace,
)
from structure_from_motion_tpu_torch.ops.ransac import draw_uniform, ransac, sample_index_sets
from structure_from_motion_tpu_torch.ops.reproj import batched_residual_jacobians, pixel_residuals
from structure_from_motion_tpu_torch.ops.small_svd import svd3
from structure_from_motion_tpu_torch.utils.control import fori, masked_loop
from structure_from_motion_tpu_torch.utils.geometry import normalized_camera_coords
from structure_from_motion_tpu_torch.utils.rotations import (
    quat_normalize,
    quat_to_rotation,
    rotation_to_quat,
)

# LM steps between two host reads of the stop mask, at most: float32 LM
# calls mostly run to their caps (10, 25, 50 and 100 at the CLI default),
# and 10 divides three of them (PERF.md)
LM_CHUNK = 10


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
    uu, s, vh = svd3(A)
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


def _lm_body(active, q, C, X, meas_norm, m, delta_h, damping: float):
    """One LM step of every active problem: any other keeps its iterate
    (``torch.where``, so a singular system of a converged problem cannot
    reach it) and stays inactive."""
    lead = q.shape[:-1]
    n = X.shape[-2]
    res, J_cam, _ = batched_residual_jacobians(
        C[..., None, :].expand(lead + (n, 3)).reshape(-1, 3),
        q[..., None, :].expand(lead + (n, 4)).reshape(-1, 4),
        X.reshape(-1, 3), meas_norm.reshape(-1, 2))
    res, J_cam = res.reshape(lead + (n, 2)), J_cam.reshape(lead + (n, 2, 7))
    mm = m
    if delta_h is not None:
        nrm = torch.linalg.norm(res, dim=-1)
        hw = torch.sqrt(torch.where(nrm <= delta_h, torch.ones_like(nrm),
                                    delta_h / nrm.clamp_min(1e-12)))
        mm = m * torch.where(delta_h > 0, hw, torch.ones_like(hw))
    res = res * mm[..., None]
    J = (J_cam * mm[..., None, None]).reshape(lead + (-1, 7))
    Jt = J.transpose(-1, -2)
    eye = torch.eye(7, dtype=X.dtype, device=X.device)
    delta = torch.linalg.solve_ex(Jt @ J + damping * eye,
                                  Jt @ res.reshape(lead + (-1, 1)))[0][..., 0]
    on = active[..., None]
    C = torch.where(on, C + delta[..., :3], C)
    q = torch.where(on, quat_normalize(q + delta[..., 3:]), q)
    return active & ((delta * delta).sum(-1) > 1e-14), q, C


def _lm_steps(q, C, X, meas_norm, mask, iterations: int, damping: float, huber_delta=0.0):
    """LM iterations on [C, q] over the masked observations, stopping once
    the squared step is <= 1e-14. ``huber_delta`` (float or tensor,
    normalised units) > 0 turns on IRLS Huber reweighting.

    Leading axes in front of the pose ((B, 4), (B, 3) over (B, N, 3) points)
    are independent problems, one a lane of the batched engine: a problem
    whose step has fallen below the threshold takes no more steps and
    keeps its iterate, and the loop (:func:`~..utils.control.masked_loop`:
    a device-side stop mask, read once every :data:`LM_CHUNK` steps) ends
    when every problem has stopped, so each gets what a call on it alone
    gives. ``huber_delta`` may then hold one value a problem."""
    lead = q.shape[:-1]
    robust = not (isinstance(huber_delta, (int, float)) and huber_delta <= 0.0)
    delta_h = (torch.as_tensor(huber_delta, dtype=X.dtype, device=X.device)[..., None]
               if robust else None)
    _, q, C = masked_loop(iterations, LM_CHUNK, functools.partial(_lm_body, damping=damping),
                          (torch.ones(lead, dtype=torch.bool, device=X.device), q, C),
                          X, meas_norm, mask.to(X.dtype), delta_h)
    return q, C


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t`` (..., N, c) at ``idx`` (..., *s) -> (..., *s, c): ``t[idx]``,
    each lane its own rows when there are leading axes."""
    lead = t.shape[:-2]
    flat = idx.reshape(lead + (-1, 1)).long()
    rows = torch.gather(t, -2, flat.expand(lead + (flat.shape[-2], t.shape[-1])))
    return rows.reshape(idx.shape + t.shape[-1:])


class PnPDraws(NamedTuple):
    """The uniforms of one :func:`sample_pnp` call, drawn beforehand, each
    with its lane axis: the scoring subset's (B, n) (None without one),
    then the hypotheses' (B, H, n), in that order from one generator."""

    sub: torch.Tensor | None
    hyp: torch.Tensor


def sample_pnp(gen, mask: torch.Tensor, config: RansacConfig):
    """(idx_sets (H, s), scoring subset (score_subset,) or None) drawn from
    ``gen`` for :func:`linear_pnp_ransac`; with a list of generators, one a
    lane, and a lane axis in front of ``mask``, the same a lane; or from
    the lanes' :class:`PnPDraws`."""
    n = mask.shape[-1]
    sub = None
    given = isinstance(gen, PnPDraws)
    if 0 < config.score_subset < n:
        u = draw_uniform(gen.sub if given else gen, (n,), mask.device)
        u = torch.where(mask, u, torch.full_like(u, float("-inf")))
        sub = stable_topk(u, config.score_subset)[1]
    # a lane's hypotheses come after its subset in its generator's stream
    idx_sets = sample_index_sets(gen.hyp if given else gen, mask, config.num_hypotheses,
                                 config.sample_num)
    return idx_sets, sub


def _lo_round(i, q, C, inl, X, meas_norm, Kp, uv, mask, *, threshold: float):
    """One LO round: weighted DLT refit on the inliers, a 10-step LM polish,
    then the pixel inliers of the result."""
    R_refit, C_refit = solve_pnp_dlt(X, meas_norm, weights=inl.to(X.dtype))
    q, C = _lm_steps(rotation_to_quat(R_refit), C_refit, X, meas_norm, inl,
                     iterations=10, damping=1e-3)
    res_pix, _ = pixel_residuals(Kp, C[..., None, :], q[..., None, :], X, uv)
    return q, C, (torch.linalg.norm(res_pix, dim=-1) < threshold) & mask


def linear_pnp_ransac(idx_sets, X, uv, K, mask, config: RansacConfig, sub=None) -> PnPResult:
    """RANSAC linear PnP over given 6-point index sets (H, 6). With
    ``0 < config.score_subset < N`` hypotheses are ranked on the valid
    subset ``sub`` and the winner re-scored on the full set. Three LO rounds
    (weighted DLT refit -> 10-step LM polish -> re-score) follow; their
    result is kept when it holds at least as many inliers. Every input may
    carry a leading lane axis ((B, H, 6), (B, N, 3), ..., (B, 3, 3)), and
    then so does every field of the result."""
    meas_norm = normalized_camera_coords(K, uv)
    thr2 = config.inlier_threshold**2
    Kb = K[..., None, None, :, :]

    def fit(idx):
        R, C = solve_pnp_dlt(_rows(X, idx), _rows(meas_norm, idx))
        return rotation_to_quat(R), C

    def inlier_matrix(qs, Cs, Xp, uvp):  # (..., H) poses x (..., N) points
        res, _ = pixel_residuals(Kb, Cs[..., None, :], qs[..., None, :], Xp[..., None, :, :],
                                 uvp[..., None, :, :])
        return (res * res).sum(-1) < thr2

    n = X.shape[-2]
    if 0 < config.score_subset < n:
        if sub is None:
            raise ValueError("linear_pnp_ransac: score_subset needs the subset indices")
        qs, Cs = fit(idx_sets)
        inl_sub = inlier_matrix(qs, Cs, _rows(X, sub), _rows(uv, sub)) \
            & torch.gather(mask, -1, sub)[..., None, :]
        best = torch.argmax(inl_sub.sum(-1), dim=-1)[..., None]
        q_best, C_best = _rows(qs, best)[..., 0, :], _rows(Cs, best)[..., 0, :]
        inliers = inlier_matrix(q_best[..., None, :], C_best[..., None, :], X, uv)[..., 0, :] & mask
    else:
        res = ransac(idx_sets, mask, fit, lambda models: inlier_matrix(*models, X, uv))
        (q_best, C_best), inliers = res.model, res.inliers
    n_best = inliers.sum(-1)

    q, C, inl = fori(3, functools.partial(_lo_round, threshold=config.inlier_threshold),
                     (q_best, C_best, inliers), X, meas_norm, K[..., None, :, :], uv, mask)
    better = (inl.sum(-1) >= n_best)[..., None]
    q_best = torch.where(better, q, q_best)
    C_best = torch.where(better, C, C_best)
    inliers = torch.where(better, inl, inliers)
    return PnPResult(R=quat_to_rotation(q_best), C=C_best, inliers=inliers,
                     num_inliers=inliers.sum(-1))


def refine_pnp(X, uv, K, mask, R0, C0, config: LMConfig):
    """Fixed-damping LM refinement of one pose (normalised-coordinate
    residuals), or of one a lane; returns (R, C)."""
    q, C = _lm_steps(rotation_to_quat(R0), C0, X, normalized_camera_coords(K, uv), mask,
                     iterations=config.iterations, damping=config.damping)
    return quat_to_rotation(q), C


def estimate_pnp(gen, X, uv, K, mask, ransac_config: RansacConfig, lm_config: LMConfig,
                 prior_R=None, prior_C=None) -> PnPResult:
    """Linear RANSAC -> (with a motion prior) a Huber-IRLS LM candidate from
    the prior, the one with more pixel inliers winning -> 25-step polish on
    the winner's inliers -> :func:`refine_pnp`. With a list of generators,
    one a lane (or the lanes' :class:`PnPDraws`), every array takes a
    leading lane axis, and so does every field of the result."""
    idx_sets, sub = sample_pnp(gen, mask, ransac_config)
    lin = linear_pnp_ransac(idx_sets, X, uv, K, mask, ransac_config, sub)
    inliers, num_inliers, R0, C0 = lin.inliers, lin.num_inliers, lin.R, lin.C
    meas_norm = normalized_camera_coords(K, uv)
    if prior_R is not None:
        delta_n = ransac_config.inlier_threshold / K[..., 0, 0]
        q_p, C_p = _lm_steps(rotation_to_quat(prior_R), prior_C, X, meas_norm, mask,
                             iterations=lm_config.iterations, damping=5.0, huber_delta=delta_n)
        res_pix, depth = pixel_residuals(K[..., None, :, :], C_p[..., None, :], q_p[..., None, :],
                                         X, uv)
        inl_p = (torch.linalg.norm(res_pix, dim=-1) < ransac_config.inlier_threshold) \
            & (depth > 0) & mask
        n_p = inl_p.sum(-1)
        use_p = n_p > num_inliers
        R0 = torch.where(use_p[..., None, None], quat_to_rotation(q_p), R0)
        C0 = torch.where(use_p[..., None], C_p, C0)
        inliers = torch.where(use_p[..., None], inl_p, inliers)
        num_inliers = torch.where(use_p, n_p, num_inliers)
    q0, C0 = _lm_steps(rotation_to_quat(R0), C0, X, meas_norm, inliers, iterations=25, damping=1e-3)
    R, C = refine_pnp(X, uv, K, inliers, quat_to_rotation(q0), C0, lm_config)
    return PnPResult(R=R, C=C, inliers=inliers, num_inliers=num_inliers)
