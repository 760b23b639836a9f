"""BAL problems in and out: the text format of Agarwal, Snavely, Seitz and
Szeliski's *Bundle Adjustment in the Large* (ECCV 2010), and the exact
change of convention into the port's global solve.

The file: ``n_cameras n_points n_observations``, then one ``camera point x
y`` line an observation, then 9 values a camera (angle-axis rotation
``w``, translation ``t``, focal length ``f``, radial ``k1``, ``k2``) and 3
a point, one value a line (any whitespace is read). Snavely's model:
``P = R(w) X + t``, ``p = -P / P_z``, ``xy = f (1 + k1 |p|^2 + k2 |p|^4)
p``, principal point at 0, residuals in pixels.

The port's camera is a centre ``C`` and a quaternion ``q`` whose rotation
``R_port`` maps camera axes to the world (``x = R_port^T (X - C)``, depth
``x_z > 0``). So ``R_port^T = diag(1, -1, -1) R(w)``, ``C = -R(w)^T t``,
and each observation's ``y`` is negated: the port's normalised point is
``(p_x, -p_y)``, ``rho^2 = |p|^2`` is unchanged, and so is every squared
residual. :func:`to_problem` makes a :class:`~..models.global_ba.GlobalProblem`
with intrinsics (an ``ops/ba.CalibratedBAState``) that
``models/global_ba.solve_global`` solves with the 10-wide camera block;
:func:`from_state` converts a solved state back. Spans
(``utils/profiling``): ``bal.read`` (:func:`read_bal`), ``global.upload``
(the raw arrays' copy to the device in :func:`to_problem`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from structure_from_motion_tpu_torch.utils import profiling
from structure_from_motion_tpu_torch.utils.rotations import (
    quat_to_rotation,
    rotation_to_quat,
    so3_exp,
)

FLIP = (1.0, -1.0, -1.0)  # diag(1, -1, -1): BAL's camera axes to the port's


class BALProblem(NamedTuple):
    """A BAL problem in BAL's own convention (numpy on the host, or tensors)."""

    cameras: np.ndarray  # (V, 9) float64: w (3), t (3), f, k1, k2
    points: np.ndarray  # (M, 3) float64
    cam: np.ndarray  # (O,) int
    point: np.ndarray  # (O,) int
    xy: np.ndarray  # (O, 2) float64 pixels


def read_bal(path) -> BALProblem:
    """Read a BAL text file (span ``bal.read``)."""
    with profiling.span("bal.read"):
        vals = np.fromfile(path, dtype=np.float64, sep=" ")
        if vals.size < 3:
            raise ValueError(f"{path}: not a BAL problem")
        V, M, O = (int(v) for v in vals[:3])
        need = 3 + 4 * O + 9 * V + 3 * M
        if vals.size != need:
            raise ValueError(f"{path}: {vals.size} numbers where a BAL problem of {V} cameras, "
                             f"{M} points and {O} observations has {need}")
        obs = vals[3:3 + 4 * O].reshape(O, 4)
        cams = vals[3 + 4 * O:3 + 4 * O + 9 * V].reshape(V, 9)
        pts = vals[3 + 4 * O + 9 * V:].reshape(M, 3)
        cam, point = obs[:, 0].astype(np.int64), obs[:, 1].astype(np.int64)
        if O and (cam.min() < 0 or cam.max() >= V or point.min() < 0 or point.max() >= M):
            raise ValueError(f"{path}: an observation names a camera or point that is not there")
        return BALProblem(cams.copy(), pts.copy(), cam, point, obs[:, 2:].copy())


def write_bal(path, p: BALProblem) -> None:
    """Write ``p`` as BAL text, every value at full float64 precision."""
    p = BALProblem(*(np.asarray(a.cpu() if torch.is_tensor(a) else a) for a in p))
    V, M, O = len(p.cameras), len(p.points), len(p.cam)
    with open(path, "w") as f:
        f.write(f"{V} {M} {O}\n")
        np.savetxt(f, np.column_stack([p.cam, p.point, p.xy]), fmt="%d %d %.17g %.17g")
        np.savetxt(f, p.cameras.reshape(-1, 1), fmt="%.17g")
        np.savetxt(f, p.points.reshape(-1, 1), fmt="%.17g")


def rotation_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) angle-axis, through the unit quaternion with
    ``w >= 0`` (angles in [0, pi])."""
    q = rotation_to_quat(R)
    v = q[..., 1:]
    s = torch.linalg.norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(s, q[..., :1])
    # angle / s -> 2 as s -> 0 (w -> 1)
    scale = torch.where(s > 1e-12, angle / s.clamp_min(1e-300), torch.full_like(s, 2.0))
    return v * scale


def _flip(dtype, device) -> torch.Tensor:
    return torch.tensor(FLIP, dtype=dtype, device=device)


def to_problem(p: BALProblem, device, dtype=torch.float32):
    """The BAL problem as a :class:`~..models.global_ba.GlobalProblem` on
    ``device``: the raw arrays are copied there (span ``global.upload``,
    which ends when the copies have: from pinned host memory at the link's
    speed), the change of convention runs there in float64, and the state
    is ``dtype``. Points and observations are padded to a multiple of 256;
    ``gids`` are the BAL point indices. One host read: the longest
    track."""
    from structure_from_motion_tpu_torch.models.global_ba import GlobalProblem
    from structure_from_motion_tpu_torch.ops.ba import BAObservations, BAState, CalibratedBAState

    device = torch.device(device)
    with profiling.span("global.upload"):
        t = [torch.as_tensor(a) for a in p]
        cams, pts, cam, point, xy = (a.to(device) for a in t)
    V, M, O = cams.shape[0], pts.shape[0], cam.shape[0]
    P_pad, O_pad = (-(-max(n, 1) // 256) * 256 for n in (M, O))
    cams, pts, xy = cams.double(), pts.double(), xy.double()
    R = so3_exp(cams[:, :3])  # BAL: world -> camera
    R_port = R.transpose(-1, -2) * _flip(R.dtype, device)  # R(w)^T diag(1, -1, -1)
    C = -(R.transpose(-1, -2) @ cams[:, 3:6, None])[..., 0]
    X = pts.new_zeros((P_pad, 3))
    X[:M] = pts
    obs_pad = O_pad - O
    uv = torch.cat([xy * _flip(xy.dtype, device)[:2], xy.new_zeros((obs_pad, 2))])
    valid = torch.arange(O_pad, device=device) < O
    state = CalibratedBAState(BAState(
        C=C.to(dtype), q=rotation_to_quat(R_port).to(dtype), X=X.to(dtype),
        cam_valid=torch.ones(V, dtype=torch.bool, device=device),
        pt_valid=torch.arange(P_pad, device=device) < M), cams[:, 6:9].to(dtype))
    obs = BAObservations(
        cam=torch.cat([cam.to(torch.int32), cam.new_zeros(obs_pad, dtype=torch.int32)]),
        point=torch.cat([point.to(torch.int32), point.new_zeros(obs_pad, dtype=torch.int32)]),
        uv_norm=uv.to(dtype), valid=valid)
    max_track = int(torch.bincount(point.long(), minlength=1).max()) if O else 0
    gids = np.full((P_pad,), -1, np.int64)
    gids[:M] = np.arange(M)
    return GlobalProblem(state, obs, gids, V, M, O, max_track)


def from_state(solved, n_points: int) -> tuple:
    """A solved ``CalibratedBAState`` in BAL's convention -> (cameras (V,
    9), points (M, 3)) as float64 tensors on the state's device (the
    inverse of :func:`to_problem`'s change: ``R(w) = diag(1, -1, -1)
    R_port^T``, ``t = -R(w) C``)."""
    state, intr = solved
    C, q, intr = state.C.double(), state.q.double(), intr.double()
    R = quat_to_rotation(q).transpose(-1, -2) * _flip(C.dtype, C.device)[:, None]
    t = -(R @ C[..., None])[..., 0]
    cams = torch.cat([rotation_to_angle_axis(R), t, intr], dim=-1)
    return cams, state.X[:n_points].double()
