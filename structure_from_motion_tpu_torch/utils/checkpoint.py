"""Checkpoint / resume for the reconstruction state (port of
``structure_from_motion_tpu/utils/checkpoint.py``).

The ``.npz`` layout is the JAX package's, key for key: one array per
:class:`SfMState` field, ``__frame``, the eviction archive as stacked
``__archive_<field>`` arrays, and the keyframe bookkeeping
(``__keyframe_indices``, ``__next_input_index``). A checkpoint written by
either package loads into the other, and so does a per-image feature cache
(``xy``, ``desc``, ``valid``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from structure_from_motion_tpu_torch.convert import state_from_numpy, state_to_numpy
from structure_from_motion_tpu_torch.models.tracks import EvictionRecord, SfMState


def save_state(path: str, state: SfMState, frame: int, archive=None,
               keyframes: tuple | None = None) -> None:
    """Write the whole engine state to one ``.npz`` file. ``archive``: the
    eviction records of slide mode; ``keyframes``: ``(keyframe_indices,
    next_input_index)``."""
    arrays = state_to_numpy(state)
    arrays["__frame"] = np.asarray(frame)
    if archive:
        for f in EvictionRecord._fields:
            arrays[f"__archive_{f}"] = np.stack([np.asarray(getattr(r, f)) for r in archive])
    if keyframes is not None:
        indices, next_input = keyframes
        arrays["__keyframe_indices"] = np.asarray(indices, np.int64)
        arrays["__next_input_index"] = np.asarray(next_input)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_state(path: str, device="cuda") -> tuple[SfMState, int, list, tuple]:
    """Load a checkpoint of either package onto ``device`` -> ``(state,
    frame, archive, keyframes)``; ``archive`` is a list of host-numpy
    :class:`EvictionRecord` rows. Older layouts load as the JAX package
    loads them: missing scalar counters read 0, a shared (3, 3) K is
    broadcast per view, missing global ids are made fresh, missing record
    fields are empty, and missing keyframe bookkeeping is the identity."""
    with np.load(path) as data:
        frame = int(data["__frame"])
        fields = {f: data[f] if f in data else np.asarray(0, np.int32)
                  for f in SfMState._fields}
        if fields["K"].ndim == 2:
            V = fields["kp_xy"].shape[0]
            fields["K"] = np.broadcast_to(fields["K"], (V, 3, 3))
        if "pt_gid" not in data:
            M = fields["points"].shape[0]
            fields["pt_gid"] = np.where(fields["pt_valid"], np.arange(M, dtype=np.int32), -1)
            fields["next_gid"] = np.asarray(M, np.int32)
        archive = []
        if "__archive_C" in data:
            stacked = {f: np.asarray(data[f"__archive_{f}"]) for f in EvictionRecord._fields
                       if f"__archive_{f}" in data}
            Kk = fields["kp_xy"].shape[1]
            dt = stacked["C"].dtype
            empty = {"K": np.zeros((3, 3), dt), "gid": np.full((Kk,), -1, np.int32),
                     "uv": np.zeros((Kk, 2), dt), "X": np.zeros((Kk, 3), dt),
                     "valid": np.zeros((Kk,), bool)}
            archive = [
                EvictionRecord(*(stacked[f][i] if f in stacked else empty[f]
                                 for f in EvictionRecord._fields))
                for i in range(stacked["C"].shape[0])
            ]
        if "__keyframe_indices" in data:
            keyframes = ([int(i) for i in data["__keyframe_indices"]],
                         int(data["__next_input_index"]))
        else:
            keyframes = (list(range(frame)), frame)
    return state_from_numpy(fields, torch.device(device)), frame, archive, keyframes


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_features_cache(path: str, xy, desc, valid) -> None:
    """Per-image feature cache: one ``.npz`` with ``xy``, ``desc``, ``valid``
    (tensors on any device or arrays), written atomically."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, xy=_host(xy), desc=_host(desc), valid=_host(valid))
    os.replace(tmp, path)


def load_features_cache(path: str):
    """-> ``(xy, desc, valid)`` numpy arrays of a cache of either package."""
    with np.load(path) as d:
        return d["xy"], d["desc"], d["valid"]
