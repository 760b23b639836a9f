"""Two-view epipolar geometry (port of ``structure_from_motion_tpu/ops/epipolar.py``).

Hartley normalisation, the batched (weighted) eight-point algorithm,
Sampson-distance RANSAC with an exact-8 special case and LO refits, and
E from F. All functions take leading batch axes, so the matcher's F-gate
runs one RANSAC per prior view in a single batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from structure_from_motion_tpu_torch.config import RansacConfig
from structure_from_motion_tpu_torch.ops.linalg import floor_abs, nullspace
from structure_from_motion_tpu_torch.ops.ransac import ransac
from structure_from_motion_tpu_torch.utils.control import fori
from structure_from_motion_tpu_torch.utils.geometry import to_homogeneous


class FundamentalResult(NamedTuple):
    F: torch.Tensor  # (..., 3, 3) in pixel coordinates, F[2,2] = 1
    inliers: torch.Tensor  # (..., N) bool
    num_inliers: torch.Tensor  # (...,)


def hartley_normalization(pts: torch.Tensor, mask: torch.Tensor, eps: float = 1e-12):
    """Masked Hartley transform: (..., N, 2) pixels -> (T (..., 3, 3),
    normalised homogeneous points (..., N, 3)) with the valid points' mean
    distance at sqrt(2)."""
    m = mask.to(pts.dtype)
    count = m.sum(-1).clamp_min(1.0)
    mean = (pts * m[..., None]).sum(-2) / count[..., None]
    dist = torch.linalg.norm(pts - mean[..., None, :], dim=-1) * m
    scale = 2.0**0.5 * count / dist.sum(-1).clamp_min(eps)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 0, 2] = -mean[..., 0] * scale
    T[..., 1, 2] = -mean[..., 1] * scale
    T[..., 2, 2].fill_(1.0)
    return T, to_homogeneous(pts) @ T.transpose(-1, -2)


def eight_point(ref_h, que_h, weights=None, eps: float = 1e-12):
    """(Weighted) eight-point algorithm on (..., N, 3) homogeneous
    correspondences -> rank-2 (..., 3, 3) F with F[2,2] == 1."""
    n = ref_h.shape[-2]
    W = (que_h[..., :, :, None] * ref_h[..., :, None, :]).reshape(*ref_h.shape[:-2], n, 9)
    if weights is not None:
        W = W * weights[..., :, None]
    f = nullspace(W)
    F = f.reshape(*f.shape[:-1], 3, 3)
    u, s, vh = torch.linalg.svd(F, full_matrices=False)
    s2 = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    F = (u * s2[..., None, :]) @ vh
    return F / floor_abs(F[..., 2:3, 2:3], eps)


def epipolar_errors(F, ref_h, que_h):
    """|x_q^T F x_r| for every (hypothesis, point): F (..., 3, 3) against
    homogeneous points (N, 3) -> (..., N)."""
    lines = torch.einsum("...ij,nj->...ni", F, ref_h)
    return (que_h * lines).sum(-1).abs()


def mean_epipolar_constraint(F, ref_pts, que_pts, mask):
    """Mean |x_q^T F x_r| over the valid pixel correspondences."""
    errs = epipolar_errors(F, to_homogeneous(ref_pts), to_homogeneous(que_pts))
    m = mask.to(F.dtype)
    return (errs * m).sum() / m.sum().clamp_min(1.0)


def point_line_distances(F, ref_pts, que_pts):
    """Pixel distance of each que point to its epipolar line F x_r."""
    lines = to_homogeneous(ref_pts) @ F.T
    num = (to_homogeneous(que_pts) * lines).sum(-1).abs()
    return num / torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2).clamp_min(1e-12)


def sampson_distances(F, ref_h, que_h):
    """Sampson epipolar distance in pixels: F (..., [H,] 3, 3) against
    points (..., N, 3) -> (..., [H,] N)."""
    if F.dim() == ref_h.dim() + 1:  # hypothesis axis: broadcast the points
        ref_h, que_h = ref_h[..., None, :, :], que_h[..., None, :, :]
    Fx = ref_h @ F.transpose(-1, -2)  # lines in que
    Ftx = que_h @ F  # lines in ref
    num = (que_h * Fx).sum(-1) ** 2
    den = Fx[..., 0] ** 2 + Fx[..., 1] ** 2 + Ftx[..., 0] ** 2 + Ftx[..., 1] ** 2
    return torch.sqrt(num / den.clamp_min(1e-18))


def _gather_rows(pts, idx):
    """pts (..., N, c), idx (..., H, s) -> (..., H, s, c)."""
    flat = idx.reshape(*idx.shape[:-2], -1, 1).long()
    return torch.take_along_dim(pts, flat, dim=-2).reshape(*idx.shape, pts.shape[-1])


def _to_pix(Fn, T_r, T_q):
    """Normalised-coordinate F (with or without a hypothesis axis) -> pixels."""
    Tq = T_q if Fn.dim() == T_q.dim() else T_q[..., None, :, :]
    Tr = T_r if Fn.dim() == T_r.dim() else T_r[..., None, :, :]
    return Tq.transpose(-1, -2) @ Fn @ Tr


def _lo_refit(i, F_norm, inliers, n_inl, inl_cur, ref_h, que_h, ref_pix, que_pix, mask, T_r,
              T_q, *, threshold: float):
    """One least-squares refit on the current consensus; kept on ties."""
    F_refit = eight_point(ref_h, que_h, weights=inl_cur.to(ref_h.dtype))
    inl_new = (sampson_distances(_to_pix(F_refit, T_r, T_q), ref_pix, que_pix) < threshold) & mask
    n_new = inl_new.sum(-1)
    take = n_new >= n_inl
    F_norm = torch.where(take[..., None, None], F_refit, F_norm)
    inliers = torch.where(take[..., None], inl_new, inliers)
    return F_norm, inliers, torch.where(take, n_new, n_inl), inl_new


def find_fundamental(
    idx_sets: torch.Tensor,
    ref_pts: torch.Tensor,
    que_pts: torch.Tensor,
    mask: torch.Tensor,
    config: RansacConfig,
) -> FundamentalResult:
    """RANSAC F on masked buffers (..., N, 2) with the given hypothesis index
    sets (..., H, 8): Hartley-normalise, batched 8-point per hypothesis,
    pixel Sampson scoring, max inliers; exactly 8 valid points take the
    direct 8-point solution; then three least-squares refits on the
    consensus set (ties go to the refit)."""
    T_r, ref_h = hartley_normalization(ref_pts, mask)
    T_q, que_h = hartley_normalization(que_pts, mask)
    ref_pix, que_pix = to_homogeneous(ref_pts), to_homogeneous(que_pts)
    thr = config.inlier_threshold

    def to_pix(Fn):
        return _to_pix(Fn, T_r, T_q)

    res = ransac(
        idx_sets,
        mask,
        fit=lambda idx: (eight_point(_gather_rows(ref_h, idx), _gather_rows(que_h, idx)),),
        score=lambda models: sampson_distances(to_pix(models[0]), ref_pix, que_pix) < thr,
    )
    # exactly 8 valid points: the direct solution, every valid point an inlier
    first8 = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)[..., :8]
    F_exact = eight_point(
        _gather_rows(ref_h, first8[..., None, :])[..., 0, :, :],
        _gather_rows(que_h, first8[..., None, :])[..., 0, :, :],
    )
    exact = mask.sum(-1) == 8
    F_norm = torch.where(exact[..., None, None], F_exact, res.model[0])
    inliers = torch.where(exact[..., None], mask, res.inliers)
    n_inl = inliers.sum(-1)

    # three LO refits (the JAX package's scan)
    F_norm, inliers, n_inl, _ = fori(
        3, functools.partial(_lo_refit, threshold=thr), (F_norm, inliers, n_inl, inliers),
        ref_h, que_h, ref_pix, que_pix, mask, T_r, T_q)

    F_pix = to_pix(F_norm)
    return FundamentalResult(
        F=F_pix / floor_abs(F_pix[..., 2:3, 2:3], 1e-12), inliers=inliers, num_inliers=n_inl
    )


def essential_from_fundamental(F, K_ref, K_que):
    """E = K_que^T F K_ref with singular values projected to (1, 1, 0),
    scaled by E[2,2]."""
    E = K_que.transpose(-1, -2) @ F @ K_ref
    u, _, vh = torch.linalg.svd(E)
    E = (u * (1.0 - torch.eye(3, dtype=E.dtype, device=E.device)[2])) @ vh  # (1, 1, 0)
    return E / floor_abs(E[..., 2:3, 2:3], 1e-12)
