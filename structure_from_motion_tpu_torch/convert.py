"""Carry an engine's state across packages as numpy arrays.

The state dict uses the field names of ``structure_from_motion_tpu.models.
tracks.SfMState``, which is also what ``jax.device_get(state)._asdict()``
gives, so a JAX engine's state can be handed to the port (and back) and both
packages can run the next stage on the same state. Eviction archives (slide
mode) cross as lists of per-record field dicts of numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from structure_from_motion_tpu_torch.device import DTYPE
from structure_from_motion_tpu_torch.models.tracks import EvictionRecord, SfMState


def state_from_numpy(d: dict, device) -> SfMState:
    """numpy dict -> :class:`SfMState` on ``device`` (floats as float32,
    integers as int32, booleans as bool). The arrays are copied, so the
    state never aliases (possibly read-only) numpy memory."""
    fields = {}
    for name in SfMState._fields:
        a = np.asarray(d[name])
        if a.dtype == np.bool_:
            dt = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dt = torch.int32
        else:
            dt = DTYPE
        fields[name] = torch.tensor(a, dtype=dt, device=device)
    return SfMState(**fields)


def state_to_numpy(state: SfMState) -> dict:
    """:class:`SfMState` -> dict of host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def archive_from_numpy(records) -> list:
    """Eviction records of either package (NamedTuples with the
    :class:`EvictionRecord` fields) -> the port's host-numpy records."""
    return [EvictionRecord(*(np.array(getattr(r, f)) for f in EvictionRecord._fields))
            for r in records]


def archive_to_numpy(archive) -> list:
    """The port's records -> list of ``{field: numpy array}`` dicts (e.g.
    ``structure_from_motion_tpu.models.tracks.EvictionRecord(**d)``)."""
    return [{f: np.array(getattr(r, f)) for f in EvictionRecord._fields} for r in archive]
