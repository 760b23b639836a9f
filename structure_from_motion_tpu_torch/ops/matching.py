"""Descriptor matching: fused L2 top-2 (kernel B3), ratio test, dedup.

Port of ``structure_from_motion_tpu/ops/matching.py`` for the L2 metric
without cross-check (the main path's matcher). :func:`match_top2` launches
``csrc/match_top2.cu`` for CUDA tensors and runs
:func:`match_top2_reference` for CPU tensors.

:func:`match_descriptors` takes a leading batch axis on the reference side,
so the incremental engine matches ALL prior views against the new view in
one kernel launch over the flattened ``(B*Nr, D)`` reference rows (the JAX
package's sequential ``lax.map`` over views).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_from_motion_tpu.config import MatcherConfig
from structure_from_motion_tpu_torch import kernels

INF = 3.0e38


class MatchResult(NamedTuple):
    target: torch.Tensor  # (..., Nr) int32 index into que keys, -1 when invalid
    valid: torch.Tensor  # (..., Nr) bool
    distance: torch.Tensor  # (..., Nr) L2 distance of the best match


def match_top2_reference(desc_ref, desc_que, mask_que):
    """Plain version: per ref row, (d1^2, d2^2, j1) over the valid que rows
    (lowest index on ties; masked que rows count as 3e38)."""
    sqq = (desc_que * desc_que).sum(1)
    d = sqq[None, :] - 2.0 * (desc_ref @ desc_que.T)
    d = torch.where(mask_que[None, :], d, torch.full_like(d, INF))
    d1, j1 = torch.min(d, dim=1)
    cols = torch.arange(d.shape[1], device=d.device)
    d2 = torch.where(cols[None, :] == j1[:, None], torch.full_like(d, INF), d).min(1).values
    sqr = (desc_ref * desc_ref).sum(1)
    return (d1 + sqr).clamp_min(0.0), (d2 + sqr).clamp_min(0.0), j1.to(torch.int32)


def match_top2(desc_ref, desc_que, mask_que):
    """(Nr, 128) x (Nq, 128) f32 -> (d1^2 (Nr,), d2^2 (Nr,), j1 (Nr,) int32)
    without materialising the (Nr, Nq) distance matrix on the card."""
    if desc_ref.device.type == "cpu":
        return match_top2_reference(desc_ref, desc_que, mask_que)
    if desc_ref.device.type != "cuda":
        raise ValueError(f"match_top2: unsupported device {desc_ref.device}")
    Nr, D = desc_ref.shape
    Nq = desc_que.shape[0]
    if D != 128 or desc_que.shape != (Nq, 128) or mask_que.shape != (Nq,):
        raise ValueError("match_top2 needs (Nr, 128), (Nq, 128) and (Nq,) inputs")
    for t in (desc_ref, desc_que):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != desc_ref.device:
            raise ValueError("match_top2: descriptors must be contiguous float32 on one device")
    if mask_que.dtype != torch.bool or mask_que.device != desc_ref.device:
        raise ValueError("match_top2: mask_que must be a bool tensor on the same device")
    if Nr == 0 or Nq == 0:
        raise ValueError("match_top2: empty descriptor set")
    dev = desc_ref.device
    sqq = (desc_que * desc_que).sum(1)
    maskq = mask_que.to(torch.uint8)
    d1 = torch.empty(Nr, dtype=torch.float32, device=dev)
    d2 = torch.empty_like(d1)
    j1 = torch.empty(Nr, dtype=torch.int32, device=dev)
    rc = kernels.library().sfm_match_top2(
        desc_ref.data_ptr(), desc_que.data_ptr(), sqq.data_ptr(), maskq.data_ptr(),
        Nr, Nq, d1.data_ptr(), d2.data_ptr(), j1.data_ptr(), kernels.stream_ptr(dev),
    )
    kernels.check(rc, "sfm_match_top2")
    match_top2.launches += 1
    sqr = (desc_ref * desc_ref).sum(1)
    return (d1 + sqr).clamp_min(0.0), (d2 + sqr).clamp_min(0.0), j1


match_top2.launches = 0


def match_descriptors(desc_ref, desc_que, mask_ref, mask_que, config: MatcherConfig):
    """Ratio-test matching with per-que dedup.

    ``desc_ref`` (Nr, D) or (B, Nr, D) with ``mask_ref`` (Nr,) / (B, Nr);
    ``desc_que`` (Nq, D), ``mask_que`` (Nq,). A ref key is kept when
    ``d1 < ratio * d2`` (unsquared L2); each que key (per batch entry) then
    keeps only its minimum-distance claimant, exact ties going to the lowest
    ref index."""
    if config.metric != "l2" or config.cross_check:
        raise ValueError("the port's matcher covers metric='l2' without cross_check")
    batched = desc_ref.dim() == 3
    if not batched:
        desc_ref, mask_ref = desc_ref[None], mask_ref[None]
    B, nr, D = desc_ref.shape
    nq = desc_que.shape[0]
    d1_sq, d2_sq, j = match_top2(desc_ref.reshape(B * nr, D), desc_que, mask_que)
    d1_sq, d2_sq, j = d1_sq.view(B, nr), d2_sq.view(B, nr), j.view(B, nr).long()
    inf = torch.full_like(d1_sq, INF)
    d1 = torch.where(mask_ref, torch.sqrt(d1_sq), inf)
    valid = mask_ref & (d1 < config.ratio * torch.sqrt(d2_sq))

    # dedup: each (batch, que) slot keeps only its minimum-distance claimant
    slot = j + nq * torch.arange(B, device=j.device)[:, None]
    dist_or_inf = torch.where(valid, d1, inf).reshape(-1)
    best = torch.full((B * nq,), INF, dtype=d1.dtype, device=d1.device)
    best.scatter_reduce_(0, slot.reshape(-1), dist_or_inf, "amin")
    is_winner = dist_or_inf <= best[slot.reshape(-1)]
    ref_ids = torch.arange(nr, device=j.device).repeat(B)
    first = torch.full((B * nq,), nr, dtype=torch.long, device=j.device)
    first.scatter_reduce_(0, slot.reshape(-1), torch.where(is_winner, ref_ids, nr), "amin")
    winner = is_winner & (first[slot.reshape(-1)] == ref_ids)
    valid = valid & winner.view(B, nr)
    target = torch.where(valid, j, -1).to(torch.int32)
    res = MatchResult(target=target, valid=valid, distance=d1)
    if not batched:
        res = MatchResult(*(t[0] for t in res))
    return res
