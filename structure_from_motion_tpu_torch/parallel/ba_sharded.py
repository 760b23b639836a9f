"""Distributed Schur-complement bundle adjustment (port of
``structure_from_motion_tpu/parallel/ba_sharded.py``).

Cameras replicate; map points and their observations shard over the ranks
of a :class:`~structure_from_motion_tpu_torch.parallel.mesh.Mesh` (one
shard a rank, see the package's docstring). Each rank assembles its
shard's blocks (kernel B4 on the card), and one LM iteration sums over the
ranks only quantities of the cameras' size:

    U (V,7,7) + the Schur coupling (7V,7V) or, in PCG, one (V,7) matvec
    coupling a CG iteration + b_red (V,7) + 2 costs

so the communication is independent of the number of points; the reduced
camera solve runs replicated on every rank (the same bits everywhere), and
the point back-substitution stays local.

Layout contract: observation o lives on the shard that owns point
``obs.point[o]`` with its point id rewritten shard-local, the layout
:func:`partition_observations` makes.

The same problem on every rank: the JAX package can count on every process
computing the same bits. The port's engine on the card does not (two runs
of it on the same frames need not give the same bits, the order of CUDA
writes to a repeated index being one cause), so the sharded paths first
give every rank rank 0's problem (:func:`replicate_first_rank`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from structure_from_motion_tpu_torch.config import BAConfig
from structure_from_motion_tpu_torch.ops.ba import (
    BAObservations,
    BAState,
    run_bundle_adjustment,
)
from structure_from_motion_tpu_torch.parallel.mesh import Mesh


def interleave_points(x: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Permute a point-axis tensor so global point p lands in shard
    ``p % num_shards`` at local offset ``p // num_shards``: the round-robin
    placement that balances sequentially allocated point ids (a block
    partition would pile every early observation onto shard 0). The output
    splits into ``num_shards`` equal blocks; pair it with
    ``partition_observations(..., interleave=True)``."""
    M = x.shape[0]
    return x.reshape((M // num_shards, num_shards) + x.shape[1:]).transpose(0, 1) \
        .reshape(x.shape)


def deinterleave_points(x: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Inverse of :func:`interleave_points`."""
    M = x.shape[0]
    return x.reshape((num_shards, M // num_shards) + x.shape[1:]).transpose(0, 1) \
        .reshape(x.shape)


def partition_observations(obs: BAObservations, num_points: int, num_shards: int,
                           per_shard_capacity: int, interleave: bool = False) -> BAObservations:
    """Route every observation to the bucket of its point's shard, its point
    id rewritten shard-local: shard s owns points ``[s * M/S, (s+1) * M/S)``
    (block), or the points ``p`` with ``p % S == s`` at local id ``p // S``
    (``interleave=True``; permute the point tensors with
    :func:`interleave_points`). The output has ``S * per_shard_capacity``
    slots, bucket s at ``[s * cap, (s+1) * cap)``; an observation's place in
    its bucket is its exclusive-prefix position among its shard's, and those
    past the capacity go to a dump slot and drop, so the returned validity
    counts what was dropped (``obs.valid.sum() - out.valid.sum()``)."""
    if num_points % num_shards:
        raise ValueError(f"{num_points=} not divisible by {num_shards=}")
    S, cap = num_shards, per_shard_capacity
    pts_per_shard = num_points // S
    point = obs.point.long()
    shard = point % S if interleave else point // pts_per_shard
    shard = torch.where(obs.valid, shard, S)  # invalid -> overflow bin
    one_hot = F.one_hot(shard, S + 1)
    pos = (torch.cumsum(one_hot, 0) - one_hot).gather(1, shard[:, None])[:, 0]
    keep = obs.valid & (pos < cap)
    dest = torch.where(keep, shard * cap + pos.clamp(max=cap - 1), S * cap)  # dump slot
    local = point // S if interleave else point - shard * pts_per_shard
    total = S * cap
    dev = obs.cam.device
    cam = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    pt = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    uv = torch.zeros((total + 1, 2), dtype=obs.uv_norm.dtype, device=dev)
    valid = torch.zeros(total + 1, dtype=torch.bool, device=dev)
    cam[dest] = obs.cam.to(torch.int32)
    pt[dest] = local.to(torch.int32)
    uv[dest] = obs.uv_norm
    valid[dest] = keep
    return BAObservations(cam=cam[:total], point=pt[:total], uv_norm=uv[:total],
                          valid=valid[:total])


def sharded_bundle_adjustment(state: BAState, obs: BAObservations, config: BAConfig,
                              mesh: Mesh, cg_iters: list | None = None):
    """BA with the points and observations sharded over ``mesh``: every rank
    passes the same whole problem, ``state.X``/``state.pt_valid`` in the
    shards' order (block, or :func:`interleave_points`) and ``obs`` in
    :func:`partition_observations` layout, and solves its own shard, the
    reduced system summed over the ranks. Returns (state with the
    replicated cameras and THIS rank's point shard in ``X`` and
    ``pt_valid``, costs): the same math as the single-device solve, in
    another order of summation (:func:`gather_point_shards` puts the
    shards back together)."""
    S, r = mesh.size, mesh.rank
    m, cap = state.X.shape[0] // S, obs.cam.shape[0] // S
    if m * S != state.X.shape[0] or cap * S != obs.cam.shape[0]:
        raise ValueError(f"{state.X.shape[0]} points and {obs.cam.shape[0]} observation slots "
                         f"must split into {S} equal shards")
    st = state._replace(X=state.X[r * m:(r + 1) * m], pt_valid=state.pt_valid[r * m:(r + 1) * m])
    ob = BAObservations(*(t[r * cap:(r + 1) * cap] for t in obs))
    psum = mesh.psum if mesh.group is not None else None
    return run_bundle_adjustment(st, ob, config, cg_iters=cg_iters, psum=psum)


def interleaved_bundle_adjustment(state: BAState, obs: BAObservations, config: BAConfig,
                                  mesh: Mesh, per_shard_capacity: int,
                                  cg_iters: list | None = None):
    """The whole problem (points in their own order, observations as they
    are) solved with its points placed round-robin over ``mesh`` and each
    shard's observations in a bucket of ``per_shard_capacity`` slots.
    Returns (state with the replicated cameras and the whole refined map in
    the problem's point order on every rank, costs, observations dropped by
    a full bucket)."""
    S = mesh.size
    part = partition_observations(obs, state.X.shape[0], S, per_shard_capacity, interleave=True)
    st = state._replace(X=interleave_points(state.X, S),
                        pt_valid=interleave_points(state.pt_valid, S))
    out, costs = sharded_bundle_adjustment(st, part, config, mesh, cg_iters)
    X = deinterleave_points(gather_point_shards(out.X, mesh), S)
    # BA leaves pt_valid as it was
    return out._replace(X=X, pt_valid=state.pt_valid), costs, obs.valid.sum() - part.valid.sum()


def replicate_first_rank(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank: an all-reduce of rank 0's tensor and
    every other rank's zeros (exact)."""
    if mesh.group is None:
        return x
    return mesh.psum(x if mesh.rank == 0 else torch.zeros_like(x)).to(x.dtype)


def gather_point_shards(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's point shard ``x`` (m, ...) -> the whole (S * m, ...)
    tensor in the shards' order, on every rank: an all-reduce of a
    zero-filled tensor into which this rank wrote its own shard."""
    if mesh.group is None:
        return x
    m = x.shape[0]
    full = torch.zeros((mesh.size * m,) + x.shape[1:], dtype=x.dtype, device=x.device)
    full[mesh.rank * m:(mesh.rank + 1) * m] = x
    return mesh.psum(full).to(x.dtype)
