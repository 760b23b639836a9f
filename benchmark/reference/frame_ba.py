"""The per-frame bundle adjustment's reference: what one lane hands the
port's per-frame BA (its cameras, map and observation store, as the BA
stage receives them) stated as the plain float64 problem that
``global_ba.solve`` solves.

The entry's arrays (``cam_C``, ``cam_q``, ``points``, ``pt_valid``,
``cam_valid``, ``K``, ``obs_cam``, ``obs_pt``, ``obs_uv``, ``obs_valid``;
one lane, no lane axis) become a :class:`global_ba.Problem`: the valid
cameras; the valid points that a kept observation sees (a point no
observation sees changes no cost); the valid observations of a valid
point and a valid camera, with their indices remapped; each pixel
normalised by its own camera's K in float64. Observations the problem
leaves out are counted: the program keeps an observation of a camera it
holds fixed, which this problem cannot state. Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("cam_C", "cam_q", "points", "pt_valid", "cam_valid", "K", "obs_cam", "obs_pt",
          "obs_uv", "obs_valid")


def assemble(entry: dict) -> dict:
    """One lane's entry -> float64 numpy ``C``, ``q``, ``X``, ``cam``,
    ``pt``, ``uv`` (normalised) for ``global_ba.to_problem``, and
    ``left_out``: the valid observations of an invalid camera or point."""
    cv = np.asarray(entry["cam_valid"], bool)
    pv = np.asarray(entry["pt_valid"], bool)
    cam = np.asarray(entry["obs_cam"], np.int64)
    pt = np.asarray(entry["obs_pt"], np.int64)
    ov = np.asarray(entry["obs_valid"], bool)
    inside = (cam >= 0) & (cam < len(cv)) & (pt >= 0) & (pt < len(pv))
    ok = ov & inside
    ok[ok] = cv[cam[ok]] & pv[pt[ok]]
    cams = np.nonzero(cv)[0]
    cam_at = np.full(len(cv), -1, np.int64)
    cam_at[cams] = np.arange(len(cams))
    pts = np.unique(pt[ok])
    pt_at = np.full(len(pv), -1, np.int64)
    pt_at[pts] = np.arange(len(pts))
    K = np.asarray(entry["K"], np.float64)
    K = np.broadcast_to(K, (len(cv), 3, 3)) if K.ndim == 2 else K
    uv = np.asarray(entry["obs_uv"], np.float64)[ok]
    Kinv = np.linalg.inv(K)[cam[ok]]
    uvn = np.einsum("oij,oj->oi", Kinv, np.concatenate([uv, np.ones((len(uv), 1))], 1))[:, :2]
    return dict(C=np.asarray(entry["cam_C"], np.float64)[cams],
                q=np.asarray(entry["cam_q"], np.float64)[cams],
                X=np.asarray(entry["points"], np.float64)[pts],
                cam=cam_at[cam[ok]], pt=pt_at[pt[ok]], uv=uvn,
                left_out=int((ov & ~ok).sum()))
