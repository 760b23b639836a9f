"""Kernel B1: separable Gaussian blur of one octave's levels.

Port of ``structure_from_motion_tpu/ops/blur_pallas.py``. :func:`blur_levels`
launches ``csrc/blur.cu`` for a CUDA tensor and runs
:func:`blur_levels_reference` for a CPU tensor; there is no other route. On
the card it serves EVERY octave: the TPU's largest-octave-only gating was
about Mosaic compile time and 128-lane alignment, neither of which applies.

The kernel takes its taps as a launch parameter (a :class:`BlurTaps` table
by value), so a call uploads nothing; :func:`taps_table` builds that table
once for each distinct list of taps.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from structure_from_motion_tpu_torch import kernels

MAX_RADIUS = 16
MAX_LEVELS = 8  # levels of one launch; longer lists take several
_TAPS = 2 * MAX_RADIUS + 1


class BlurTaps(ctypes.Structure):
    """``struct BlurTaps`` of ``csrc/blur.cu``: level l's taps are
    ``k[l][0 .. 2 * radius[l]]``."""

    _fields_ = [("radius", ctypes.c_int * MAX_LEVELS),
                ("k", (ctypes.c_float * _TAPS) * MAX_LEVELS)]


_tables: dict[tuple, BlurTaps] = {}


def taps_table(kernels_1d: list) -> BlurTaps:
    """The launch parameter for up to ``MAX_LEVELS`` odd 1-D kernels, built
    once per content: the key is every level's taps, byte for byte, so other
    taps of the same lengths get another table."""
    taps = [np.ascontiguousarray(k, np.float32).reshape(-1) for k in kernels_1d]
    key = tuple(t.tobytes() for t in taps)
    table = _tables.get(key)
    if table is None:
        if not 0 < len(taps) <= MAX_LEVELS:
            raise ValueError(f"taps_table: 1 to {MAX_LEVELS} levels, got {len(taps)}")
        table = BlurTaps()
        for lvl, t in enumerate(taps):
            if t.size % 2 != 1 or t.size > _TAPS:
                raise ValueError(f"blur_levels: taps must be odd with radius <= {MAX_RADIUS}")
            table.radius[lvl] = t.size // 2
            table.k[lvl][: t.size] = t.tolist()
        if len(_tables) >= 64:  # callers use a handful of sigma lists
            _tables.clear()
        _tables[key] = table
    return table


def blur_levels_reference(base: torch.Tensor, kernels_1d: list) -> torch.Tensor:
    """(H, W) f32 -> (L, H, W): level l = zero-padded 'SAME' separable
    correlation of ``base`` with the odd 1-D taps ``kernels_1d[l]``."""
    x = base[None, None]
    out = []
    for k in kernels_1d:
        r = (len(k) - 1) // 2
        kt = torch.as_tensor(np.asarray(k, np.float32), device=base.device)
        h = F.conv2d(x, kt.view(1, 1, 1, -1), padding=(0, r))
        out.append(F.conv2d(h, kt.view(1, 1, -1, 1), padding=(r, 0))[0, 0])
    return torch.stack(out)


def blur_levels(base: torch.Tensor, kernels_1d: list) -> torch.Tensor:
    """(H, W) f32 -> (L, H, W) blurred levels (see the reference above)."""
    if base.device.type == "cpu":
        return blur_levels_reference(base, kernels_1d)
    if base.device.type != "cuda":
        raise ValueError(f"blur_levels: unsupported device {base.device}")
    if base.dtype != torch.float32 or base.dim() != 2 or not base.is_contiguous():
        raise ValueError("blur_levels needs a contiguous (H, W) float32 tensor")
    L = len(kernels_1d)
    H, W = base.shape
    if L == 0 or H == 0 or W == 0:
        raise ValueError("blur_levels: need L, H, W > 0")
    out = torch.empty((L, H, W), dtype=torch.float32, device=base.device)
    lib, stream = kernels.library(), kernels.stream_ptr(base.device)
    for l0 in range(0, L, MAX_LEVELS):
        part = kernels_1d[l0 : l0 + MAX_LEVELS]
        rc = lib.sfm_blur_levels(base.data_ptr(), ctypes.byref(taps_table(part)), len(part),
                                 H, W, out[l0].data_ptr(), stream)
        kernels.check(rc, "sfm_blur_levels")
        blur_levels.launches += 1
        blur_levels.by_shape[(H, W, len(part))] += 1
    return out


blur_levels.launches = 0
blur_levels.by_shape = collections.Counter()  # launches by (H, W, levels)
