"""Plain float64 numpy geometry that judges the program's answers: the
similarity-aligned trajectory error (a frozen copy of the port's
``utils/metrics.py``, Umeyama 1991). Imports nothing of the port."""

from __future__ import annotations

import numpy as np


def umeyama(src, dst):
    """Similarity (s, R, t) minimising ||dst - (s R src + t)||^2; (N, 3) each."""
    src, dst = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(dc.T @ sc / len(src))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    var = (sc ** 2).sum() / len(src)
    s = float(np.trace(np.diag(S) @ D) / var) if var > 0 else 1.0
    return s, R, mu_d - s * R @ mu_s


def aligned_errors(est, truth) -> np.ndarray:
    """(N,) distance of each estimated centre from its true one after the
    similarity alignment of the whole set, as a share of the true path's
    span (the diagonal of its bounding box)."""
    est, truth = np.asarray(est, np.float64), np.asarray(truth, np.float64)
    if not np.all(np.isfinite(est)):
        return np.full(len(est), np.inf)
    s, R, t = umeyama(est, truth)
    err = np.linalg.norm((s * (R @ est.T)).T + t - truth, axis=1)
    return err / np.linalg.norm(truth.max(0) - truth.min(0))
