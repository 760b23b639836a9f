"""Kernel B2: fused DoG candidate response.

Port of ``structure_from_motion_tpu/ops/features_pallas.py``.
:func:`candidate_response` launches ``csrc/cand.cu`` for a CUDA tensor and
runs :func:`candidate_response_reference` for a CPU tensor. Both give the
same numbers bit for bit (the kernel's Hessian arithmetic is explicitly
rounded); any H and W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from structure_from_motion_tpu_torch import kernels


def candidate_response_reference(
    dog: torch.Tensor, contrast: float, edge_threshold: float, border: int = 8
) -> torch.Tensor:
    """(S+2, H, W) f32 DoG -> (S, H, W): |D| where D (layer 1..S) is a 3x3x3
    extremum (ties count), |D| > contrast, Lowe's 2x2 Hessian edge test
    passes and (y, x) is >= ``border`` from the edges; else 0."""
    S2, H, W = dog.shape
    x = dog[None, None]
    wmax = F.max_pool3d(x, 3, stride=1, padding=1)[0, 0]
    wmin = -F.max_pool3d(-x, 3, stride=1, padding=1)[0, 0]
    c = dog[1:-1]
    is_ext = (c >= wmax[1:-1]) | (c <= wmin[1:-1])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dog.device)  # noqa: E731
    cok = c.abs() > f32(contrast)

    def sh(a, dy, dx):  # value at (y + dy, x + dx); wraps, border-masked
        return torch.roll(a, shifts=(-dy, -dx), dims=(1, 2))

    c2 = 2.0 * c
    dxx = sh(c, 0, 1) - c2 + sh(c, 0, -1)
    dyy = sh(c, 1, 0) - c2 + sh(c, -1, 0)
    dxy = 0.25 * (sh(c, 1, 1) - sh(c, 1, -1) - sh(c, -1, 1) + sh(c, -1, -1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = f32(edge_threshold)
    eok = (det > 0) & (tr * tr * r < f32((edge_threshold + 1.0) ** 2) * det)
    rows = torch.arange(H, device=dog.device)[:, None]
    cols = torch.arange(W, device=dog.device)[None, :]
    bm = (rows >= border) & (rows < H - border) & (cols >= border) & (cols < W - border)
    return torch.where(is_ext & cok & eok & bm[None], c.abs(), torch.zeros_like(c))


def candidate_response(
    dog: torch.Tensor, contrast: float, edge_threshold: float, border: int = 8
) -> torch.Tensor:
    """(S+2, H, W) f32 DoG stack -> (S, H, W) masked |response| map."""
    if dog.device.type == "cpu":
        return candidate_response_reference(dog, contrast, edge_threshold, border)
    if dog.device.type != "cuda":
        raise ValueError(f"candidate_response: unsupported device {dog.device}")
    if dog.dtype != torch.float32 or dog.dim() != 3 or not dog.is_contiguous():
        raise ValueError("candidate_response needs a contiguous (S+2, H, W) float32 tensor")
    S2, H, W = dog.shape
    if S2 < 3 or H == 0 or W == 0:
        raise ValueError(f"candidate_response: bad DoG shape {tuple(dog.shape)}")
    out = torch.empty((S2 - 2, H, W), dtype=torch.float32, device=dog.device)
    rc = kernels.library().sfm_candidate_response(
        dog.data_ptr(), S2 - 2, H, W, float(contrast), float(edge_threshold),
        float((edge_threshold + 1.0) ** 2), int(border), out.data_ptr(),
        kernels.stream_ptr(dog.device),
    )
    kernels.check(rc, "sfm_candidate_response")
    candidate_response.launches += 1
    return out


candidate_response.launches = 0
