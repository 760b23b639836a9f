"""Inputs of kernel B7 (``ops/small_svd.py``) made with numpy from a seed:
the systems the frame path solves, at its shapes, and the cases its
designs can get wrong. ``tests/test_torch_small_svd.py`` holds the plain
version to the JAX package and numpy on :func:`cases`, and on the card the
kernel to the plain version; ``chip_smoke.py`` runs :func:`cases` beside the
slice's recorded inputs; ``tools/profile_kernels.py`` times the kernel on
:func:`slice_inputs`."""

from __future__ import annotations

import numpy as np
import torch

f32 = np.float32

# (batch, M, N, full) of every B7 launch of a slice frame at the command
# line's default config (chip_smoke.py's phase 3 records them): the eight-
# point fits and F_exact, the PnP minimal fits, the F and PnP LO refits,
# the triangulation rows, and the 3 x 3 factors
SLICE_SHAPES = (
    (2048, 8, 9, False), (16, 8, 9, False), (1024, 12, 12, False), (16, 2048, 9, False),
    (1, 16384, 12, False), (1, 32768, 12, False), (1, 65536, 12, False),
    (2048, 4, 4, False), (8192, 4, 4, False),
    (2048, 3, 3, True), (16, 3, 3, True), (1024, 3, 3, True), (1, 3, 3, True),
)


def dlt_rows(rng, n: int, noise: float) -> np.ndarray:
    """(n, 12, 12) PnP DLT systems of 6 noisy points each (``ops/pnp.py``)."""
    X = rng.uniform([-4, -3, 8], [4, 3, 16], size=(n, 6, 3))
    uv = X[..., :2] / X[..., 2:] + noise * rng.normal(size=(n, 6, 2))
    Xh = np.concatenate([X, np.ones_like(X[..., :1])], -1)
    z = np.zeros_like(Xh)
    r1 = np.concatenate([Xh, z, -uv[..., :1] * Xh], -1)
    r2 = np.concatenate([z, Xh, -uv[..., 1:] * Xh], -1)
    return np.concatenate([r1, r2], -2).astype(f32)


def tall_dlt(rng, rows: int, noise: float = 1e-3) -> np.ndarray:
    """(1, rows, 12): one PnP refit's DLT system of rows / 2 points."""
    return dlt_rows(rng, -(-rows // 12), noise).reshape(1, -1, 12)[:, :rows].copy()


def eight_point_rows(rng, n: int, m: int, repeat: int = 0) -> np.ndarray:
    """(n, m, 9) eight-point design rows of noisy correspondences; the
    first ``repeat`` rows of each repeated (a degenerate sample)."""
    a = rng.normal(size=(n, m, 3)).astype(f32)
    a[..., 2] = 1.0
    b = a + 0.01 * rng.normal(size=a.shape).astype(f32)
    b[..., 2] = 1.0
    W = (b[..., :, None] * a[..., None, :]).reshape(n, m, 9)
    if repeat:
        W[:, 1:repeat] = W[:, :1]
    return W


def weighted(rng, W: np.ndarray, keep: float) -> np.ndarray:
    """A refit's rows: each row kept (weight 1) with probability ``keep``,
    else zeroed."""
    return W * (rng.random(W.shape[:-1] + (1,)) < keep).astype(f32)


def triangulation_rows(rng, n: int) -> np.ndarray:
    """(n, 4, 4) two-view DLT rows u P_2 - P_0, v P_2 - P_1 of noisy points
    (``ops/triangulation.py``)."""
    X = np.concatenate([rng.uniform([-4, -3, 8], [4, 3, 16], size=(n, 3)), np.ones((n, 1))], 1)
    rows = []
    for C in ([0.0, 0.0, 0.0], [1.0, 0.1, 0.2]):
        P = np.concatenate([np.eye(3), -np.asarray(C)[:, None]], 1)
        x = X @ P.T
        uv = x[:, :2] / x[:, 2:] + 1e-3 * rng.normal(size=(n, 2))
        rows += [uv[:, :1] * P[2] - P[0], uv[:, 1:] * P[2] - P[1]]
    return np.stack(rows, 1).astype(f32)


def at_scales(W: np.ndarray, scales) -> np.ndarray:
    """``W`` (n, m, N) with its rows cut into ``len(scales)`` equal runs,
    each multiplied by its scale."""
    runs = np.array_split(np.arange(W.shape[1]), len(scales))
    out = W.copy()
    for idx, sc in zip(runs, scales):
        out[:, idx] *= f32(sc)
    return out


def close_pair(rng, n: int, N: int, gap: float) -> np.ndarray:
    """(n, N, N) matrices U diag(s) V^T with s from 1 down to 1e-3 and the
    two smallest singular values ``gap`` apart."""
    U = np.linalg.qr(rng.normal(size=(n, N, N)))[0]
    V = np.linalg.qr(rng.normal(size=(n, N, N)))[0]
    s = np.logspace(0, -3, N)
    s[-2] = s[-1] + gap
    return ((U * s[None, None, :]) @ V.transpose(0, 2, 1)).astype(f32)


def cases() -> dict:
    """Named (batch, M, N) inputs of the null vector: the frame path's
    shapes, degenerate samples, and the cases the kernel's designs can get
    wrong (the tall one-launch reduction at the slice's largest shape and
    with most of its blocks' R zero; two close smallest singular values
    for the Jacobi order and stopping test; entries whose squares overflow
    f32, as a masked candidate's Hartley scale gives them, in blocks of
    different scales)."""
    rng = np.random.default_rng(0)
    tall = weighted(rng, eight_point_rows(rng, 4, 2048), 0.6)
    return {
        "8x9 hypotheses": eight_point_rows(rng, 64, 8),
        "8x9 repeated points": eight_point_rows(rng, 16, 8, repeat=3),
        "2048x9 weighted refit": tall,
        "12x12 PnP samples": dlt_rows(rng, 64, 1e-3),
        "4096x12 PnP refit": dlt_rows(rng, 683, 1e-3).reshape(1, -1, 12)[:, :4096],
        "4x4 triangulation": rng.normal(size=(256, 4, 4)).astype(f32),
        "zero matrices": np.zeros((3, 8, 9), f32),
        "65536x12 PnP refit": tall_dlt(rng, 65536),
        "16x2048x9 refit, 90% zero weights": weighted(rng, eight_point_rows(rng, 16, 2048), 0.1),
        "12x12 two smallest 5e-5 apart": close_pair(rng, 64, 12, 5e-5),
        "8x9 hypotheses at 1e30": eight_point_rows(rng, 16, 8) * f32(1e30),
        "4096x9 refit, halves at 1e30 and 1e24": at_scales(
            weighted(rng, eight_point_rows(rng, 2, 4096), 0.6), (1e30, 1e24)),
        "12x12 PnP samples at 1e25": dlt_rows(rng, 16, 1e-3) * f32(1e25),
    }


def slice_inputs(seed: int = 0) -> dict:
    """``{(batch, M, N, full): (batch, M, N) float32}`` at every shape of
    :data:`SLICE_SHAPES`, each the kind of system the frame path solves."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in SLICE_SHAPES:
        batch, M, N, full = key
        if full:
            A = rng.normal(size=(batch, 3, 3)).astype(f32)
        elif N == 9:
            W = eight_point_rows(rng, batch, M)
            A = weighted(rng, W, 0.6) if M > N else W
        elif N == 12:
            A = dlt_rows(rng, batch, 1e-3) if M == 12 else tall_dlt(rng, M)
        else:
            A = triangulation_rows(rng, batch)
        out[key] = A
    return out


def null_vector_error(A, v, w) -> tuple:
    """How far the null vectors ``v`` (..., N) of the (..., M, N) torch
    batch ``A`` stand from the plain version's ``w``: (the largest
    difference where the two smallest singular values are 1e-3 of the
    largest apart, how many are, the largest |1 - |v||, the slack: the
    largest |A v| - |A w| - 1e-4 s_max). The kernel is held to err <= 1e-3,
    unit <= 1e-5, slack <= 0 and finite values."""
    s = torch.linalg.svdvals(A.double())
    N = A.shape[-1]
    top = s[..., :1].clamp_min(1e-30)
    s_full = torch.cat([s, s.new_zeros(s.shape[:-1] + (N - s.shape[-1],))], -1)
    gap = (s_full[..., -2] - s_full[..., -1]) > 1e-3 * top[..., 0]
    err = float((v - w)[gap].abs().max()) if gap.any() else 0.0
    Ad = A.double()
    res_v = (Ad @ v.double()[..., None]).norm(dim=(-2, -1))
    res_w = (Ad @ w.double()[..., None]).norm(dim=(-2, -1))
    unit = float((v.norm(dim=-1) - 1).abs().max())
    slack = float((res_v - res_w - 1e-4 * top[..., 0]).max())
    return err, int(gap.sum()), unit, slack
