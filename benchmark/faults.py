"""Faults planted in the timed path, to show that the comparison which
decides ``correct`` catches them (``run.py --fault <name>``, and the CPU
tests). The benchmark's own runs never plant one.

* ``unchanged``: a step that returns its state unchanged (a frame step of
  either engine; each LM step of a bundle adjustment);
* ``half_lanes``: half of the batch left out (the batched engine's second
  half of lanes keeps its state through every step);
* ``altered``: an answer altered where it is produced (every third frame's
  new camera centre moved by two world units along x).
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("unchanged", "half_lanes", "altered")


@contextlib.contextmanager
def planted(name: str | None):
    """The port with fault ``name`` planted for the block (None: as it is)."""
    if name is None:
        yield
        return
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
    from structure_from_motion_tpu_torch.models import batched, incremental
    from structure_from_motion_tpu_torch.models.tracks import SfMState
    from structure_from_motion_tpu_torch.ops import ba

    step = incremental._frame_step
    frames = [0]

    def faulty(st, v, draws, frame, config, graphs=None):
        new, info = step(st, v, draws, frame, config, graphs)
        if name == "unchanged":
            return st, info
        if name == "half_lanes":
            h = st.points.shape[0] // 2
            return SfMState(*(torch.cat([a[:h], b[h:]]) for a, b in zip(new, st))), info
        frames[0] += 1
        if frames[0] % 3 == 0:
            C = new.cam_C.clone()
            C[:, v, 0] += 2.0
            new = new._replace(cam_C=C)
        return new, info

    saved = [(incremental, "_frame_step", step), (batched, "_frame_step", batched._frame_step),
             (ba, "_apply_step", ba._apply_step)]
    incremental._frame_step = batched._frame_step = faulty
    if name == "unchanged":
        ba._apply_step = lambda state, dc, dp: state
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
