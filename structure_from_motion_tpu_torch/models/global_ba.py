"""Whole-trajectory bundle adjustment over a sliding-window run (port of
``structure_from_motion_tpu/models/global_ba.py``).

The sliding window freezes each camera's pose at eviction. At the end of a
run the eviction archive (host-numpy :class:`~structure_from_motion_tpu_torch.
models.tracks.EvictionRecord` rows) and the live window reassemble into ONE
BA problem over every camera, keyed by the persistent global point ids, and
the same Schur-LM engine solves it, PCG with kernels B5 and B6 from
``pcg_fallback_cameras`` cameras up: on one device in the tiered ELL
layout, or sharded over the ranks of a process group
(``parallel/ba_sharded.py``) in the hybrid ELL (uniform rows plus a
point-sorted spill tail) a shard.

The assembly (:func:`build_global_problem`) and the tiered packing
(:func:`tiered_problem`, :func:`pack_tiered`) run on the state's device:
the archive is stacked on the host and uploaded once a field, and the
union, the support count, the seeds, the normalisation and the packing
are sorts, searches, scatters and gathers there. The host reads only what
sets a shape or stays on the host (the sizes with the live intrinsics, the
kept global ids, the track-length histogram with the busiest camera's
count), each a grouped copy and one wait, counted in :data:`host_reads`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from structure_from_motion_tpu_torch.config import BAConfig
from structure_from_motion_tpu_torch.device import HostCopy, clamp_index, repeat_each, to_device
from structure_from_motion_tpu_torch.models.tracks import EvictionRecord, SfMState
from structure_from_motion_tpu_torch.ops.ba import (
    BAObservations,
    BAState,
    run_bundle_adjustment,
)
from structure_from_motion_tpu_torch.parallel import (
    Mesh,
    interleaved_bundle_adjustment,
    make_mesh,
    replicate_first_rank,
)
from structure_from_motion_tpu_torch.utils import profiling

host_reads = 0  # grouped device-to-host reads of the assembly and the packing, since the process began


class GlobalProblem(NamedTuple):
    """A reassembled whole-trajectory BA problem plus what is needed to
    write the refined result back into the engine."""

    state: BAState  # cameras = [archived..., live window...]
    obs: BAObservations
    gids: np.ndarray  # (P,) global point id per (padded) point row, -1 pad
    n_cams: int
    n_points: int  # real points (rows beyond are padding)
    n_obs: int  # real observations (rows beyond are padding)
    max_track_len: int


def _round_up(n: int, mult: int) -> int:
    return ((max(n, 1) + mult - 1) // mult) * mult


def _read(*tensors) -> HostCopy:
    """A grouped host copy of ``tensors``, started now and waited for at
    its ``arrays()``; counted in :data:`host_reads`."""
    global host_reads
    host_reads += 1
    return HostCopy(tensors)


def _stack(arrays: list, pin: bool = False) -> torch.Tensor:
    """``np.stack(arrays)`` as a host tensor (pinned where ``pin``), filled
    by one concatenation of the arrays along their first axis (numpy's
    ``stack`` also makes a view of every array)."""
    first = np.asarray(arrays[0])
    dtype = torch.from_numpy(np.empty((0,), first.dtype)).dtype
    buf = torch.empty((len(arrays),) + first.shape, dtype=dtype, pin_memory=pin)
    np.concatenate(arrays, out=buf.numpy().reshape((-1,) + first.shape[1:]))
    return buf


def _scatter_rows(dest: torch.Tensor, n: int, *values: torch.Tensor) -> list:
    """Each of ``values`` with its rows at ``dest`` in ``n`` zero-filled
    rows. Every kept row has a destination of its own; a ``dest`` of ``n``
    drops the row (all such rows share one extra row, so the order of the
    scatter's writes decides nothing that is kept)."""
    out = []
    for v in values:
        buf = v.new_zeros((n + 1,) + tuple(v.shape[1:]))
        buf[dest] = v
        out.append(buf[:n])
    return out


def _compact(keep: torch.Tensor, n: int, *values: torch.Tensor) -> list:
    """The rows of each of ``values`` where ``keep``, in their order, as the
    first of ``n`` zero-filled rows."""
    return _scatter_rows(torch.where(keep, torch.cumsum(keep, 0) - 1, n), n, *values)


def seed_winners(sel: torch.Tensor, src_gid: torch.Tensor) -> torch.Tensor:
    """For each kept global id of ``sel`` (ascending), the index of the
    LAST entry of ``src_gid`` that holds it (-1 where none does): with the
    sources in write order (archived slots by eviction, then the live
    map), later evictions win and the live map wins over all. A max over
    positions, so the answer does not hang on the order of a scatter."""
    P = sel.shape[0]
    win = torch.full((P + 1,), -1, dtype=torch.int64, device=sel.device)
    if P == 0:
        return win[:0]
    key = src_gid.to(sel.dtype)
    j = torch.searchsorted(sel, key).clamp(max=P - 1)
    ok = (src_gid >= 0) & (sel[j] == key)
    pos = torch.arange(src_gid.shape[0], device=sel.device)
    win.scatter_reduce_(0, torch.where(ok, j, P), pos, "amax")
    return win[:P]


def build_global_problem(state: SfMState, archive: Sequence[EvictionRecord], n_live: int,
                         min_obs: int = 2, pad_multiple: int = 256) -> GlobalProblem:
    """Union the eviction archive with the live window into one BA problem
    on the state's device.

    Cameras: ``len(archive)`` archived poses, then the ``n_live`` live
    poses (the order of :meth:`IncrementalSfM.poses`). Points: every
    global id observed ``>= min_obs`` times across the union, seeded from
    the live map when still alive, else from its last eviction
    (:func:`seed_winners`). Pixel observations are normalised with each
    view's own K. Points and observations are padded to ``pad_multiple``.

    The archive's fields are stacked on the host (on the card into pinned
    memory) and uploaded without a wait, one copy a field (K stays on the
    host); the live state is read where it is. The host makes two reads
    (:func:`_read`): the point and observation counts and the longest track
    with the live views' K (every K is inverted on the host, as numpy
    inverts it), then the kept global ids (``gids``)."""
    dev = state.points.device
    A = len(archive)
    Kk = int(np.asarray(archive[0].gid).shape[0]) if A else 0
    fields = ("C", "q", "gid", "uv", "X", "valid")
    pin = dev.type == "cuda"
    arc = {f: _stack([getattr(r, f) for r in archive], pin).to(dev, non_blocking=True)
           for f in fields} if A else {
        "C": state.cam_C[:0], "q": state.cam_q[:0], "gid": state.pt_gid[:0],
        "uv": state.obs_uv[:0], "X": state.points[:0], "valid": state.obs_valid[:0]}
    arc_K = _stack([r.K for r in archive]).numpy() if A else None
    F = A + n_live

    # candidates: the archived slots (record by record), then the live
    # store's slots; an empty slot's id is -1
    lv = state.obs_valid
    live_pt = clamp_index(state.obs_pt.long(), state.pt_gid.shape[0])
    cand_gid = torch.cat([torch.where(arc["valid"], arc["gid"], -1).reshape(-1),
                          torch.where(lv, state.pt_gid[live_pt], -1)])
    arc_cam = repeat_each(torch.arange(A, dtype=torch.int32, device=dev), Kk)
    cand_cam = torch.cat([arc_cam, state.obs_cam.to(torch.int32) + A])
    cand_uv = torch.cat([arc["uv"].reshape(-1, 2), state.obs_uv])

    # support: sort the ids, a run's extent by two searches
    big = torch.iinfo(torch.int64).max
    key = torch.where(cand_gid >= 0, cand_gid.long(), big)
    s = torch.sort(key).values
    lo = torch.searchsorted(s, key)
    support = torch.searchsorted(s, key, right=True) - lo
    keep = (cand_gid >= 0) & (support >= min_obs)
    lo_s = torch.searchsorted(s, s)
    run = torch.searchsorted(s, s, right=True) - lo_s
    head = (lo_s == torch.arange(s.shape[0], device=dev)) & (s != big) & (run >= min_obs)
    dense = torch.cumsum(head, 0) - 1  # a kept id's point row, at its run's head
    sizes = torch.stack([head.sum(), keep.sum(), torch.where(head, run, 0).max()])
    sizes, live_K = _read(sizes, state.K[:n_live]).arrays()
    P_real, O_real, max_track = (int(v) for v in sizes)
    sel = _compact(head, P_real, s)[0]
    gids_read = _read(sel)

    P_pad, O_pad = _round_up(P_real, pad_multiple), _round_up(O_real, pad_multiple)
    cam, point, uv = _compact(keep, O_pad, cand_cam, dense[lo].to(torch.int32), cand_uv)
    valid = torch.arange(O_pad, device=dev) < O_real

    # normalise pixels with each camera's own K, in numpy's float32 einsum
    # order over [u, v, 1] (the u and v terms summed first)
    cam_K = np.concatenate([arc_K, live_K]) if A else live_K
    Kinv = to_device(torch.from_numpy(np.linalg.inv(cam_K)), dev)[cam.long(), :2]
    uv_norm = (Kinv[..., 0] * uv[:, :1] + Kinv[..., 1] * uv[:, 1:]) + Kinv[..., 2]
    uv_norm = torch.where(valid[:, None], uv_norm, 0).to(state.cam_C.dtype)

    # point seeds: the archived slots in eviction order, then the live map
    src_gid = torch.cat([cand_gid[:A * Kk], torch.where(state.pt_valid, state.pt_gid, -1)])
    src_X = torch.cat([arc["X"].reshape(-1, 3), state.points])
    win = seed_winners(sel, src_gid)
    X = src_X.new_zeros((P_pad, 3))
    X[:P_real] = torch.where(win[:, None] >= 0, src_X[win.clamp(min=0)], 0)

    ba_state = BAState(
        C=torch.cat([arc["C"], state.cam_C[:n_live]]),
        q=torch.cat([arc["q"], state.cam_q[:n_live]]),
        X=X,
        cam_valid=torch.ones((F,), dtype=torch.bool, device=dev),
        pt_valid=torch.arange(P_pad, device=dev) < P_real,
    )
    obs = BAObservations(cam=cam, point=point, uv_norm=uv_norm, valid=valid)
    gids_out = np.full((P_pad,), -1, np.int64)
    gids_out[:P_real] = gids_read.arrays()[0]
    return GlobalProblem(ba_state, obs, gids_out, F, P_real, O_real, max_track)


def choose_tiers(counts_desc: np.ndarray, round_to: int = 256) -> tuple:
    """Static tier partition ((n_points, rows), ...) for a descending
    track-length histogram: boundaries at power-of-2 counts, rows = the
    tier's largest count, tier sizes rounded up to ``round_to`` points
    (a smaller multiple of 8 where the rounding would pad a few very long
    tracks past the slot budget), zero-observation points last."""
    M = int(counts_desc.size)
    budget = max(64 * round_to, int(counts_desc.sum()) // 2)
    tiers: list = []
    i = 0
    while i < M and counts_desc[i] > 0:
        c = int(counts_desc[i])
        pow2 = 1 << (c - 1).bit_length() if c > 1 else 1
        j = max(int(np.searchsorted(-counts_desc, -(pow2 // 2), side="left")), i + 1)
        step = round_to
        if ((-(j - i)) % step) * c > budget:
            step = max(8, (budget // c) // 8 * 8)
        j = min(i + _round_up(j - i, step), M)
        tiers.append((j - i, int(counts_desc[i])))
        i = j
    if i < M:
        tiers.append((M - i, 0))
    return tuple(tiers)


def pack_tiered(obs: BAObservations, tiers: tuple, order, align: int = 512) -> BAObservations:
    """Packing into the tiered-ELL layout, on ``obs``'s device. ``order``
    (numpy or a tensor): original id of each renumbered point row
    (descending track length); tier t owns the next ``n_t`` points x
    ``rows_t`` slots; the stream is padded to an ``align`` multiple. A
    stable sort of the valid observations by new point id, each one's rank
    in its point, and scatters into distinct slots; no host read."""
    dev = obs.cam.device
    order = torch.as_tensor(order, device=dev).long()
    M = order.shape[0]
    rows_of = np.repeat([r for _, r in tiers], [n for n, _ in tiers]).astype(np.int64)
    used = int(rows_of.sum())
    total = used + (-used) % align
    rows_of = to_device(torch.from_numpy(rows_of), dev)
    base = torch.cumsum(rows_of, 0) - rows_of  # each new point's first slot

    newid = torch.empty_like(order)
    newid[order] = torch.arange(M, device=dev)
    key = torch.where(obs.valid, newid[clamp_index(obs.point.long(), M)], M)  # invalid rows last
    key_s, o2 = torch.sort(key, stable=True)
    rank = torch.arange(key_s.shape[0], device=dev) - torch.searchsorted(key_s, key_s)
    ok = key_s < M
    dest = torch.where(ok, base[key_s.clamp(max=M - 1)] + rank, total)

    cam_t, uv_t, val_t = _scatter_rows(dest, total, obs.cam[o2], obs.uv_norm[o2], ok)
    pt_t = torch.repeat_interleave(torch.arange(M, dtype=torch.int32, device=dev), rows_of,
                                   output_size=used)
    pt_t = torch.cat([pt_t, pt_t.new_zeros(total - used)])
    return BAObservations(cam_t, pt_t, uv_t, val_t)


def tiered_problem(problem: GlobalProblem):
    """Renumber points by descending track length and pack the stream into
    tiers -> (state, obs, tiers, order, cam_rows); ``cam_rows`` sizes the
    camera-major view to the busiest camera from 64 cameras up. ``order``
    is a tensor on the problem's device. The histogram, its stable
    descending order and the camera counts are made on the device; the host
    reads the sorted histogram and the busiest camera's count in one
    :func:`_read`, and :func:`choose_tiers` runs on them."""
    obs = problem.obs
    dev = obs.cam.device
    V, M_pad = problem.state.C.shape[0], problem.state.X.shape[0]
    ones = obs.valid.to(torch.int64)
    counts = torch.zeros(M_pad, dtype=torch.int64, device=dev).index_add_(0, obs.point.long(), ones)
    order = torch.sort(-counts, stable=True).indices
    per_cam = torch.zeros(V, dtype=torch.int64, device=dev).index_add_(0, obs.cam.long(), ones)
    counts_desc, cam_max = _read(counts[order], per_cam.max()).arrays()
    tiers = choose_tiers(counts_desc)
    obs_t = pack_tiered(obs, tiers, order)
    st = problem.state._replace(X=problem.state.X[order], pt_valid=problem.state.pt_valid[order])
    cam_rows = _round_up(int(cam_max), 8) if V >= 64 else 0
    return st, obs_t, tiers, order, cam_rows


_SPILL_COST = 12  # relative cost of one CSR-tail slot vs one dense ELL slot


def _choose_ell_rows(counts: np.ndarray, m_pad: int) -> tuple[int, int]:
    """The hybrid-ELL row count for a track-length histogram: minimises
    ``m_pad * rows + _SPILL_COST * spilled(rows)``, ``spilled(rows)`` being
    the observations past each point's first ``rows`` (the JAX package's
    price of a tail slot against a dense one). Returns (rows, spilled)."""
    if counts.size == 0 or counts.max() == 0:
        return 1, 0
    max_t = int(counts.max())
    hist = np.bincount(counts, minlength=max_t + 2)
    ge = np.cumsum(hist[::-1])[::-1]  # ge[k] = #points with count >= k
    suffix = np.concatenate([np.cumsum(ge[::-1])[::-1], [0]])
    rows = np.arange(1, max_t + 1)
    spilled = suffix[rows + 1]  # sum_{c > r} (c - r) * hist[c]
    cost = m_pad * rows.astype(np.int64) + _SPILL_COST * spilled
    best = int(np.argmin(cost))
    return int(rows[best]), int(spilled[best])


def _align_tail(n_dense: int, tail: int, mult: int = 512) -> int:
    """The tail padded so the stream's length is a multiple of ``mult``
    (the JAX package's 512-row kernel tile; the padding slots are
    invalid)."""
    total = n_dense + tail
    return tail + (-total) % mult


def solve_global(problem: GlobalProblem, ba_config: BAConfig, iterations: int = 20,
                 num_shards: int = 1, stats: dict | None = None):
    """Schur-LM over a reassembled global problem -> (state in the problem's
    point order, costs numpy): on one device in the tiered layout, or with
    ``num_shards`` > 1 sharded over that many ranks (:func:`solve_sharded`;
    every rank calls this with the same problem). ``stats``, when given,
    receives the layout (``tiers``, ``slots``) and the PCG
    ``cg_iterations`` of each LM iteration. Spans (``utils/profiling``):
    ``global.pack`` (the layout, made on the device), ``global.lm`` (the LM
    iterations) and ``global.fetch`` (the points back in the problem's
    order, the costs to the host), on either path."""
    if num_shards > 1:
        return solve_sharded(problem, ba_config, make_mesh(num_shards), iterations, stats)
    with profiling.span("global.pack"):
        st, obs_t, tiers, order, cam_rows = tiered_problem(problem)
    cfg = dataclasses.replace(ba_config, iterations=iterations, obs_layout="tiered",
                              tiers=tiers, ell_rows=0, ell_tail=0, cam_rows=cam_rows)
    cg_iters: list = []
    with profiling.span("global.lm"):
        out, costs = run_bundle_adjustment(st, obs_t, cfg, cg_iters=cg_iters)
    with profiling.span("global.fetch"):
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        out = out._replace(X=out.X[inv], pt_valid=out.pt_valid[inv])
        costs = costs.cpu().numpy()
    if stats is not None:
        stats.update(tiers=tiers, slots=int(obs_t.cam.shape[0]), cg_iterations=cg_iters)
    return out, costs


def solve_sharded(problem: GlobalProblem, ba_config: BAConfig, mesh: Mesh,
                  iterations: int = 20, stats: dict | None = None):
    """The global problem sharded over ``mesh``: points placed round-robin
    (point p in shard p % S), observations partitioned into buckets of
    ``round_up(ceil(O/S * 1.25), 8)``, each shard a hybrid ELL whose row
    count suits the whole histogram and whose tail and camera-major view are
    sized to the worst shard (one layout for every rank). Returns the JAX
    package's single-device contract on every rank, for rank 0's problem:
    (state with the whole refined map, ``X`` and ``pt_valid`` in the
    problem's point order, costs). ``stats`` as in :func:`solve_global`,
    with ``tiers`` the ELL block of one shard and ``tail`` its spill
    slots."""
    with profiling.span("global.pack"):
        # rank 0's problem on every rank (see parallel/ba_sharded.py)
        problem = problem._replace(
            state=BAState(*(replicate_first_rank(t, mesh) for t in problem.state)),
            obs=BAObservations(*(replicate_first_rank(t, mesh) for t in problem.obs)))
        point, cam, valid = _read(problem.obs.point, problem.obs.cam, problem.obs.valid).arrays()
        V, M = problem.state.C.shape[0], problem.state.X.shape[0]
        O = problem.obs.cam.shape[0]
        S = mesh.size
        counts = np.bincount(point[valid], minlength=M)
        rows, _ = _choose_ell_rows(counts, M)
        obs_shard = (point % S)[valid]
        spill_shard = np.bincount(np.arange(M) % S, weights=np.maximum(counts - rows, 0),
                                  minlength=S)
        tail = _align_tail((M // S) * rows, int(spill_shard.max()))
        cam_max = max(int(np.bincount(cam[valid][obs_shard == s], minlength=V).max(initial=0))
                      for s in range(S))
        cam_rows = _round_up(cam_max, 8) if V >= 64 else 0
        cfg = dataclasses.replace(ba_config, iterations=iterations, obs_layout="ell",
                                  ell_rows=rows, ell_tail=tail, cam_rows=cam_rows)
        bucket = _round_up(int(np.ceil(O / S * 1.25)), 8)
    cg_iters: list = []
    with profiling.span("global.lm"):
        out, costs, _ = interleaved_bundle_adjustment(problem.state, problem.obs, cfg, mesh,
                                                      bucket, cg_iters)
    with profiling.span("global.fetch"):
        costs = costs.cpu().numpy()
    if stats is not None:
        stats.update(tiers=((M // S, rows),), tail=tail, slots=(M // S) * rows + tail,
                     bucket=bucket, cg_iterations=cg_iters)
    return out, costs
