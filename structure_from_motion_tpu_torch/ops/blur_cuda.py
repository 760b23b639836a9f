"""Kernel B1: separable Gaussian blur of one octave's levels.

Port of ``structure_from_motion_tpu/ops/blur_pallas.py``. :func:`blur_levels`
launches ``csrc/blur.cu`` for a CUDA tensor and runs
:func:`blur_levels_reference` for a CPU tensor; there is no other route. On
the card it serves EVERY octave: the TPU's largest-octave-only gating was
about Mosaic compile time and 128-lane alignment, neither of which applies.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from structure_from_motion_tpu_torch import kernels

MAX_RADIUS = 16
_TAPS = 2 * MAX_RADIUS + 1


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
    radii = [(len(k) - 1) // 2 for k in kernels_1d]
    if L == 0 or H == 0 or W == 0 or max(radii) > MAX_RADIUS:
        raise ValueError(f"blur_levels: need L, H, W > 0 and radius <= {MAX_RADIUS}")
    table = np.zeros((L, _TAPS), np.float32)
    for lvl, (k, r) in enumerate(zip(kernels_1d, radii)):
        table[lvl, MAX_RADIUS - r : MAX_RADIUS + r + 1] = np.asarray(k, np.float32)
    dev = base.device
    taps = torch.from_numpy(table).to(dev)
    rad = torch.tensor(radii, dtype=torch.int32, device=dev)
    mid = torch.empty((L, H, W), dtype=torch.float32, device=dev)
    out = torch.empty_like(mid)
    rc = kernels.library().sfm_blur_levels(
        base.data_ptr(), taps.data_ptr(), rad.data_ptr(), L, H, W,
        mid.data_ptr(), out.data_ptr(), kernels.stream_ptr(dev),
    )
    kernels.check(rc, "sfm_blur_levels")
    blur_levels.launches += 1
    return out


blur_levels.launches = 0
