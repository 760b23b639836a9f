"""Invariant validation of the reconstruction state (port of
``structure_from_motion_tpu/utils/debug.py``).

* :func:`validate_state`: host-side structural invariants of an
  :class:`~structure_from_motion_tpu_torch.models.tracks.SfMState` (index
  ranges, mask consistency, match-table symmetry, finite values, unit
  quaternions, capacity overflow). Returns a list of violations (empty =
  healthy). A lane-stacked state of the batched engine is checked lane by
  lane, each finding prefixed with its lane.
* :func:`nan_guard`: replaces non-finite entries of a tensor and counts
  them, without a host read.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def validate_state(state) -> list[str]:
    """Check every structural invariant of an ``SfMState`` (or of each lane
    of a lane-stacked one); list the violations."""
    if np.ndim(state.num_points) == 1:  # (B,) counters: a lane stack
        return [f"lane {b}: {p}" for b in range(len(state.num_points))
                for p in validate_state(type(state)(*(t[b] for t in state)))]
    problems: list[str] = []
    V, Kk = state.tri_index.shape
    M = state.points.shape[0]
    tri = _np(state.tri_index)
    pt_valid = _np(state.pt_valid)
    obs_cam, obs_pt = _np(state.obs_cam), _np(state.obs_pt)
    obs_valid, cam_valid = _np(state.obs_valid), _np(state.cam_valid)
    mt = _np(state.match_table)

    if tri.max() >= M:
        problems.append(f"tri_index exceeds map capacity ({tri.max()} >= {M})")
    used = tri[tri >= 0]
    if used.size and not pt_valid[used].all():
        problems.append("tri_index points at invalid map slots")
    num_points = int(_np(state.num_points))
    if num_points != int(pt_valid.sum()):
        problems.append(f"num_points {num_points} != valid count {int(pt_valid.sum())}")
    if obs_valid.any():
        oc, op = obs_cam[obs_valid], obs_pt[obs_valid]
        if (oc < 0).any() or (oc >= V).any():
            problems.append("observation camera index out of range")
        elif not cam_valid[oc].all():
            problems.append("observation references an invalid camera")
        if (op < 0).any() or (op >= M).any():
            problems.append("observation point index out of range")
        elif not pt_valid[op].all():
            problems.append("observation references an invalid map point")
    # match-table symmetry: mt[u, v, k] = j  =>  mt[v, u, j] = k
    for u in range(V):
        for v in range(V):
            row = mt[u, v]
            ks = np.nonzero(row >= 0)[0]
            if ks.size and not (mt[v, u][row[ks]] == ks).all():
                problems.append(f"match table asymmetric for pair ({u}, {v})")
    if not np.isfinite(_np(state.points)[pt_valid]).all():
        problems.append("non-finite map points")
    C, q = _np(state.cam_C)[cam_valid], _np(state.cam_q)[cam_valid]
    if not np.isfinite(C).all():
        problems.append("non-finite camera centers")
    if q.size and np.abs(np.linalg.norm(q, axis=1) - 1.0).max() > 1e-4:
        problems.append("non-unit camera quaternions")
    # a saturated map looks like convergence ("no new points") unless the
    # dropped admissions are surfaced
    ndp, ndo = int(_np(state.dropped_points)), int(_np(state.dropped_obs))
    if ndp > 0:
        problems.append(f"map capacity overflow: {ndp} points dropped")
    if ndo > 0:
        problems.append(f"observation capacity overflow: {ndo} observations dropped")
    return problems


def nan_guard(x: torch.Tensor, replace: float = 0.0):
    """(cleaned tensor, count of non-finite entries replaced), on the device."""
    bad = ~torch.isfinite(x)
    return torch.where(bad, torch.full_like(x, replace), x), bad.sum()
