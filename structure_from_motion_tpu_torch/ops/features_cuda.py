"""Kernel B2: fused DoG candidate response, with and without the 8x8 block
argmax.

Port of ``structure_from_motion_tpu/ops/features_pallas.py``.
:func:`candidate_block_max` (the detector's path when 8 divides H and W)
gives each 8x8 block's largest masked response and its place in the block
without ever writing the (S, H, W) map; :func:`candidate_response` writes
the map (any H and W; :func:`block_argmax` reduces it for a block other
than 8). Each launches its kernel of ``csrc/cand.cu`` for a
CUDA tensor and runs its plain version (``*_reference``) for a CPU tensor.
Kernel and plain version give the same numbers bit for bit (the kernels'
Hessian arithmetic is explicitly rounded).
"""

from __future__ import annotations

import collections

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
    candidate_response.by_shape[(H, W)] += 1
    return out


candidate_response.launches = 0
candidate_response.by_shape = collections.Counter()  # launches by (H, W)


BLOCK = 8  # the fused kernel's block


def block_argmax(resp: torch.Tensor, block: int = BLOCK):
    """(S, H, W) response map, ``block`` | H, W -> ``(cand, pos)``, both
    (S, H/block, W/block): the largest value of each block and its place
    ``dy * block + dx`` there (int32). Among equal values the lowest row
    that holds the block's maximum wins, and in it the lowest column; a
    block of zeros gives 0. Two single-axis reductions, as the JAX package
    reduces the map."""
    S, h, w = resp.shape
    B = block
    if B < 1 or h % B or w % B:
        raise ValueError(f"block_argmax: {B} must divide H and W of {tuple(resp.shape)}")
    hb, wb = h // B, w // B
    r4 = resp.reshape(S, h, wb, B)
    ax1 = torch.argmax(r4, dim=3).reshape(S, hb, B, wb)
    r5 = r4.amax(dim=3).reshape(S, hb, B, wb)
    ax2 = torch.argmax(r5, dim=2, keepdim=True)  # (S, hb, 1, wb)
    dx = torch.gather(ax1, 2, ax2)
    return r5.amax(dim=2), (ax2 * B + dx)[:, :, 0].to(torch.int32)


def candidate_block_max_reference(
    dog: torch.Tensor, contrast: float, edge_threshold: float, border: int = 8,
    block: int = BLOCK,
):
    """(S+2, H, W) f32 DoG, ``block`` | H, W -> ``(cand, pos)`` of
    :func:`block_argmax` over the masked response map: the plain version of
    :func:`candidate_block_max` (``block`` = 8 there)."""
    resp = candidate_response_reference(dog, contrast, edge_threshold, border)
    return block_argmax(resp, block)


def candidate_block_max(
    dog: torch.Tensor, contrast: float, edge_threshold: float, border: int = 8
):
    """(S+2, H, W) f32 DoG stack -> ``(cand, pos)`` of its 8x8 blocks (see
    :func:`candidate_block_max_reference`). On the card: 1 <= S <= 4,
    ``border`` >= 1 and a contiguous, 16-byte aligned stack."""
    if dog.device.type == "cpu":
        return candidate_block_max_reference(dog, contrast, edge_threshold, border)
    if dog.device.type != "cuda":
        raise ValueError(f"candidate_block_max: unsupported device {dog.device}")
    if dog.dtype != torch.float32 or dog.dim() != 3 or not dog.is_contiguous():
        raise ValueError("candidate_block_max needs a contiguous (S+2, H, W) float32 tensor")
    S2, H, W = dog.shape
    if not 3 <= S2 <= 6 or H == 0 or W == 0 or H % BLOCK or W % BLOCK:
        raise ValueError(f"candidate_block_max on the card: {BLOCK} must divide H and W, with "
                         f"1 to 4 layers; got {tuple(dog.shape)}")
    if border < 1 or dog.data_ptr() % 16:
        raise ValueError("candidate_block_max needs border >= 1 and a 16-byte aligned stack")
    shape = (S2 - 2, H // BLOCK, W // BLOCK)
    cand = torch.empty(shape, dtype=torch.float32, device=dog.device)
    pos = torch.empty(shape, dtype=torch.int32, device=dog.device)
    rc = kernels.library().sfm_candidate_block_max(
        dog.data_ptr(), S2 - 2, H, W, float(contrast), float(edge_threshold),
        float((edge_threshold + 1.0) ** 2), int(border), cand.data_ptr(), pos.data_ptr(),
        kernels.stream_ptr(dog.device),
    )
    kernels.check(rc, "sfm_candidate_block_max")
    candidate_block_max.launches += 1
    candidate_block_max.by_shape[(H, W)] += 1
    return cand, pos


candidate_block_max.launches = 0
candidate_block_max.by_shape = collections.Counter()  # launches by (H, W)
