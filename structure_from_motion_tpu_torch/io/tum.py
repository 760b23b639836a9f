"""TUM trajectory export: `timestamp tx ty tz qx qy qz qw` per camera (port
of ``structure_from_motion_tpu/io/tum.py``; the same text for the same poses).

The de-facto interchange format for trajectory evaluation (TUM RGB-D
tools, `evo`, rpg_trajectory_evaluation): one line per pose, cam-to-world
translation (= camera center) and Hamilton quaternion in **xyzw** order.
The reference persists poses only as a pickle of its own arrays
(``view_pose.pkl``, ``ba_processor.py:443-546``); this writes the format
every external ATE/RPE tool consumes, so `evo_ape tum golden.tum ours.tum`
works out of the box.

Host-side, float64 on the CPU — runs once at the end of a reconstruction.
"""

from __future__ import annotations

import numpy as np
import torch

from structure_from_motion_tpu_torch.utils.rotations import quat_to_rotation, rotation_to_quat


def export_tum_trajectory(
    path: str,
    locs: np.ndarray,
    rots: np.ndarray,
    timestamps: np.ndarray | None = None,
) -> int:
    """Write a TUM-format trajectory file.

    ``locs``: (F, 3) camera centers, ``rots``: (F, 3, 3) cam-to-world
    rotations (the framework's native convention, reference
    ``view_processor.py:56``). ``timestamps`` defaults to the frame index.
    Returns the number of poses written.
    """
    C = np.asarray(locs, np.float64)
    R = np.asarray(rots, np.float64)
    if C.ndim != 2 or C.shape[1] != 3 or R.shape != (len(C), 3, 3):
        raise ValueError(f"bad trajectory shapes: locs {C.shape}, rots {R.shape}")
    ts = (
        np.arange(len(C), dtype=np.float64)
        if timestamps is None
        else np.asarray(timestamps, np.float64)
    )
    q = rotation_to_quat(torch.as_tensor(R)).numpy()  # (F, 4) wxyz, cam-to-world
    q = q * np.where(q[:, :1] < 0, -1.0, 1.0)  # deterministic sign
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(len(C)):
            f.write(
                f"{ts[i]:.6f} {C[i, 0]:.9f} {C[i, 1]:.9f} {C[i, 2]:.9f} "
                f"{q[i, 1]:.9f} {q[i, 2]:.9f} {q[i, 3]:.9f} {q[i, 0]:.9f}\n"
            )
    return len(C)


def load_tum_trajectory(path: str):
    """Read a TUM-format file -> (timestamps (F,), locs (F,3), rots (F,3,3))."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 8:
                raise ValueError(f"bad TUM line ({len(vals)} fields): {line!r}")
            rows.append(vals)
    a = np.asarray(rows, np.float64).reshape(-1, 8)
    ts, C, qxyzw = a[:, 0], a[:, 1:4], a[:, 4:8]
    q = np.concatenate([qxyzw[:, 3:4], qxyzw[:, 0:3]], axis=1)  # -> wxyz
    R = quat_to_rotation(torch.as_tensor(q)).numpy()
    return ts, C, R
