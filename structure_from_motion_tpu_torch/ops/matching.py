"""Descriptor matching: fused L2 top-2 (kernel B3), Hamming distances,
ratio test, cross-check, dedup.

Port of ``structure_from_motion_tpu/ops/matching.py``. :func:`match_top2`
calls the ``sfm::match_top2`` operator, which launches
``csrc/match_top2.cu`` for CUDA tensors and runs
:func:`match_top2_reference` for CPU tensors; it takes a lane axis, each
lane's references against that lane's queries, in one launch. The Hamming
metric and cross-check use no kernel in the JAX package either
(``use_pallas`` there is ``metric == "l2" and not cross_check``): they
build the whole distance matrix with one product, as it does.

:func:`match_descriptors` takes a leading batch axis on the reference side,
so the incremental engine matches ALL prior views against the new view in
one kernel launch over the flattened ``(B*Nr, D)`` reference rows (the JAX
package's sequential ``lax.map`` over views), and a lane axis in front of
both sides for the batched engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_from_motion_tpu_torch.config import MatcherConfig
from structure_from_motion_tpu_torch import kernels
from structure_from_motion_tpu_torch.device import stable_topk

INF = 3.0e38


class MatchResult(NamedTuple):
    target: torch.Tensor  # (..., Nr) int32 index into que keys, -1 when invalid
    valid: torch.Tensor  # (..., Nr) bool
    distance: torch.Tensor  # (..., Nr) L2 distance of the best match


def match_top2_reference(desc_ref, desc_que, mask_que):
    """Plain version: per ref row, (d1^2, d2^2, j1) over the valid que rows
    (lowest index on ties; masked que rows count as 3e38). With a lane axis
    ((B, Nr, D), (B, Nq, D), (B, Nq)) each lane's rows meet its own
    queries."""
    sqq = (desc_que * desc_que).sum(-1)
    d = sqq[..., None, :] - 2.0 * (desc_ref @ desc_que.transpose(-1, -2))
    d = torch.where(mask_que[..., None, :], d, torch.full_like(d, INF))
    d1, j1 = torch.min(d, dim=-1)
    cols = torch.arange(d.shape[-1], device=d.device)
    d2 = torch.where(cols == j1[..., None], torch.full_like(d, INF), d).min(-1).values
    sqr = (desc_ref * desc_ref).sum(-1)
    return (d1 + sqr).clamp_min(0.0), (d2 + sqr).clamp_min(0.0), j1.to(torch.int32)


@torch.library.custom_op("sfm::match_top2", mutates_args=(), device_types="cpu")
def _match_top2_op(desc_ref: torch.Tensor, desc_que: torch.Tensor,
                   mask_que: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B3 as an operator: the plain version on the CPU, the kernel on the
    card, no other device."""
    return match_top2_reference(desc_ref, desc_que, mask_que)


@_match_top2_op.register_fake
def _(desc_ref, desc_que, mask_que):
    lead = desc_ref.shape[:-1]
    return (desc_ref.new_empty(lead), desc_ref.new_empty(lead),
            desc_ref.new_empty(lead, dtype=torch.int32))


def _check(desc_ref, desc_que, mask_que) -> int:
    """What the kernel takes -> the lane count (0 without a lane axis)."""
    lanes = desc_ref.shape[0] if desc_ref.dim() == 3 else 0
    Nr, D = desc_ref.shape[-2:]
    Nq = desc_que.shape[-2] if desc_que.dim() >= 2 else 0
    lead = desc_ref.shape[:-2]
    if D != 128 or desc_que.shape != lead + (Nq, 128) or mask_que.shape != lead + (Nq,):
        raise ValueError("match_top2 needs (Nr, 128), (Nq, 128) and (Nq,) inputs, or the "
                         "same with one lane axis in front of each")
    for t in (desc_ref, desc_que):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != desc_ref.device:
            raise ValueError("match_top2: descriptors must be contiguous float32 on one device")
    if mask_que.dtype != torch.bool or mask_que.device != desc_ref.device \
            or not mask_que.is_contiguous():
        raise ValueError("match_top2: mask_que must be a contiguous bool tensor on the same "
                         "device")
    if Nr == 0 or Nq == 0 or (desc_ref.dim() == 3 and not 0 < lanes <= 65535):
        raise ValueError("match_top2: empty descriptor set, or not 1 to 65535 lanes")
    return lanes


@_match_top2_op.register_kernel("cuda")
def _(desc_ref, desc_que, mask_que):
    lanes = _check(desc_ref, desc_que, mask_que)
    Nr, Nq = desc_ref.shape[-2], desc_que.shape[-2]
    lead = desc_ref.shape[:-2]
    dev = desc_ref.device
    sqq = (desc_que * desc_que).sum(-1)
    maskq = mask_que.to(torch.uint8)
    d1 = torch.empty(lead + (Nr,), dtype=torch.float32, device=dev)
    d2 = torch.empty_like(d1)
    j1 = torch.empty(lead + (Nr,), dtype=torch.int32, device=dev)
    lib, stream = kernels.library(), kernels.stream_ptr(dev)
    ptrs = (desc_ref.data_ptr(), desc_que.data_ptr(), sqq.data_ptr(), maskq.data_ptr())
    outs = (d1.data_ptr(), d2.data_ptr(), j1.data_ptr(), stream)
    rc = lib.sfm_match_top2_lanes(*ptrs, max(lanes, 1), Nr, Nq, *outs)
    kernels.check(rc, "sfm_match_top2_lanes")
    match_top2.launches += 1
    sqr = (desc_ref * desc_ref).sum(-1)
    return (d1 + sqr).clamp_min(0.0), (d2 + sqr).clamp_min(0.0), j1


def match_top2(desc_ref, desc_que, mask_que):
    """(Nr, 128) x (Nq, 128) f32 -> (d1^2 (Nr,), d2^2 (Nr,), j1 (Nr,) int32)
    without materialising the (Nr, Nq) distance matrix on the card; with a
    lane axis, (B, Nr, 128) x (B, Nq, 128) with (B, Nq) masks -> (B, Nr)
    each, in one launch (the ``sfm::match_top2`` operator)."""
    if desc_ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"match_top2: unsupported device {desc_ref.device}")
    if desc_ref.device.type == "cuda":
        _check(desc_ref, desc_que, mask_que)
    return torch.ops.sfm.match_top2(desc_ref, desc_que, mask_que)


match_top2.launches = 0


def squared_distances(desc_ref, desc_que, mask_ref, mask_que):
    """Masked (..., Nr, Nq) squared L2 distances (3e38 where either key is
    masked), clamped at 0; one product, leading axes broadcast."""
    cross = desc_ref.float() @ desc_que.float().transpose(-1, -2)
    sq_r = (desc_ref.float() ** 2).sum(-1)[..., :, None]
    sq_q = (desc_que.float() ** 2).sum(-1)[..., None, :]
    d2 = (sq_r + sq_q - 2.0 * cross).clamp_min(0.0)
    d2 = torch.where(mask_que[..., None, :], d2, torch.full_like(d2, INF))
    return torch.where(mask_ref[..., :, None], d2, torch.full_like(d2, INF))


def hamming_distances(desc_ref, desc_que, mask_ref, mask_que):
    """Masked (..., Nr, Nq) Hamming distances of +-1 codes by one product:
    ham(a, b) = (D - a.b) / 2; 3e38 where either key is masked."""
    D = desc_ref.shape[-1]
    ham = 0.5 * (D - desc_ref.float() @ desc_que.float().transpose(-1, -2))
    ham = torch.where(mask_que[..., None, :], ham, torch.full_like(ham, INF))
    return torch.where(mask_ref[..., :, None], ham, torch.full_like(ham, INF))


def _top2_of(d, sqrt: bool):
    """(d1, d2nd, j) of a full distance matrix (..., Nr, Nq): the two
    smallest per row, lowest index first among equals."""
    neg, idx = stable_topk(-d, 2)
    d1, d2nd = (-neg[..., 0]).clamp_min(0.0), (-neg[..., 1]).clamp_min(0.0)
    if sqrt:
        d1, d2nd = torch.sqrt(d1), torch.sqrt(d2nd)
    return d1, d2nd, idx[..., 0]


def match_descriptors(desc_ref, desc_que, mask_ref, mask_que, config: MatcherConfig):
    """Ratio-test matching with optional cross-check and per-que dedup.

    ``desc_que`` (Nq, D) with ``mask_que`` (Nq,), against ``desc_ref``
    (Nr, D) or (G, Nr, D) with ``mask_ref`` (Nr,) / (G, Nr); or, for a lane
    axis, ``desc_que`` (B, Nq, D), ``mask_que`` (B, Nq) against (B, Nr, D) or
    (B, G, Nr, D). A ref key is kept when ``d1 < ratio * d2`` (unsquared L2,
    or Hamming for ``metric="hamming"``); with ``cross_check`` it must also
    be its match's nearest ref key; each que key (per group) then keeps only
    its minimum-distance claimant, exact ties going to the lowest ref
    index."""
    if config.metric not in ("l2", "hamming"):
        raise ValueError(f"unknown matcher metric {config.metric!r}")
    laned = desc_que.dim() == 3
    if not laned:
        desc_ref, mask_ref = desc_ref[None], mask_ref[None]
        desc_que, mask_que = desc_que[None], mask_que[None]
    grouped = desc_ref.dim() == 4
    if not grouped:
        desc_ref, mask_ref = desc_ref[:, None], mask_ref[:, None]
    L, G, nr, D = desc_ref.shape
    nq = desc_que.shape[1]
    if config.metric == "hamming" or config.cross_check:
        dist = (hamming_distances if config.metric == "hamming" else squared_distances)(
            desc_ref, desc_que[:, None], mask_ref, mask_que[:, None])  # (L, G, nr, nq)
        d1, d2nd, j = _top2_of(dist, sqrt=config.metric == "l2")
    else:
        if laned:
            d1_sq, d2_sq, j = match_top2(desc_ref.reshape(L, G * nr, D), desc_que.contiguous(),
                                         mask_que.contiguous())
        else:  # the one-lane launch
            d1_sq, d2_sq, j = match_top2(desc_ref.reshape(G * nr, D), desc_que[0], mask_que[0])
        d1_sq, d2_sq, j = d1_sq.view(L, G, nr), d2_sq.view(L, G, nr), j.view(L, G, nr).long()
        d1 = torch.where(mask_ref, torch.sqrt(d1_sq), torch.full_like(d1_sq, INF))
        d2nd = torch.sqrt(d2_sq)
    valid = mask_ref & (d1 < config.ratio * d2nd)
    if config.cross_check:
        back = torch.argmin(dist, dim=-2)  # (L, G, nq): nearest ref of every que key
        ref_ids = torch.arange(nr, device=j.device)
        valid = valid & (torch.gather(back, -1, j) == ref_ids)

    # dedup: each (group, que) slot keeps only its minimum-distance claimant
    inf = torch.full_like(d1, INF)
    n_groups = L * G
    slot = (j.reshape(n_groups, nr) + nq * torch.arange(n_groups, device=j.device)[:, None])
    slot = slot.reshape(-1)
    dist_or_inf = torch.where(valid, d1, inf).reshape(-1)
    best = torch.full((n_groups * nq,), INF, dtype=d1.dtype, device=d1.device)
    best.scatter_reduce_(0, slot, dist_or_inf, "amin")
    is_winner = dist_or_inf <= best[slot]
    ref_ids = torch.arange(nr, device=j.device).repeat(n_groups)
    first = torch.full((n_groups * nq,), nr, dtype=torch.long, device=j.device)
    first.scatter_reduce_(0, slot, torch.where(is_winner, ref_ids, nr), "amin")
    winner = is_winner & (first[slot] == ref_ids)
    valid = valid & winner.view(L, G, nr)
    target = torch.where(valid, j, -1).to(torch.int32)
    res = MatchResult(target=target, valid=valid, distance=d1)
    if not grouped:
        res = MatchResult(*(t[:, 0] for t in res))
    if not laned:
        res = MatchResult(*(t[0] for t in res))
    return res
