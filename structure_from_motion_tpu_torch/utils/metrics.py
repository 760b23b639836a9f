"""Quality metrics (port of ``structure_from_motion_tpu/utils/metrics.py``):
similarity-aligned absolute trajectory error (the standard SfM/SLAM
benchmark metric) and reprojection statistics over the observation store.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Closed-form similarity (s, R, t) minimising ||dst - (s R src + t)||^2
    (Umeyama 1991). ``src``/``dst``: (N, 3)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    var = (sc**2).sum() / len(src)
    s = float(np.trace(np.diag(S) @ D) / var) if var > 0 else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def absolute_trajectory_error(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS ATE after similarity alignment. ``est``/``gt``: (N, 3) centers."""
    s, R, t = umeyama_alignment(est, gt)
    aligned = (s * (R @ np.asarray(est, np.float64).T)).T + t
    return float(np.sqrt(((aligned - np.asarray(gt)) ** 2).sum(axis=1).mean()))


def reprojection_stats(state) -> dict:
    """Mean/median/p95 pixel reprojection error over valid observations of
    an :class:`~structure_from_motion_tpu_torch.models.tracks.SfMState`
    (residuals on the state's device, statistics on the host)."""
    from structure_from_motion_tpu_torch.ops.reproj import pixel_residuals

    cam, pt = state.obs_cam.long(), state.obs_pt.long()
    res, _ = pixel_residuals(state.K[cam], state.cam_C[cam], state.cam_q[cam],
                             state.points[pt], state.obs_uv)
    valid = state.obs_valid.cpu().numpy()
    err = np.linalg.norm(res.cpu().numpy(), axis=-1)[valid]
    if len(err) == 0:
        return {"count": 0}
    return {
        "count": int(len(err)),
        "mean_px": float(err.mean()),
        "median_px": float(np.median(err)),
        "p95_px": float(np.percentile(err, 95)),
        "max_px": float(err.max()),
    }
