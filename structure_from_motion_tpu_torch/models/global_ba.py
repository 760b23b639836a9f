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

Assembly is host-side numpy (once per reconstruction; data-dependent
shapes); only the solve runs on the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from structure_from_motion_tpu_torch.config import BAConfig
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


def _stack_archive(archive: Sequence[EvictionRecord]) -> EvictionRecord | None:
    """One record of stacked host arrays (leading axis = eviction order)."""
    if not archive:
        return None
    return EvictionRecord(*[np.stack([np.asarray(getattr(r, f)) for r in archive])
                            for f in EvictionRecord._fields])


def build_global_problem(state: SfMState, archive: Sequence[EvictionRecord], n_live: int,
                         min_obs: int = 2, pad_multiple: int = 256) -> GlobalProblem:
    """Union the eviction archive with the live window into one BA problem
    on the state's device.

    Cameras: ``len(archive)`` archived poses, then the ``n_live`` live
    poses (the order of :meth:`IncrementalSfM.poses`). Points: every
    global id observed ``>= min_obs`` times across the union, seeded from
    the live map when still alive, else from its last eviction. Pixel
    observations are normalised with each view's own K. Points and
    observations are padded to ``pad_multiple``."""
    st = {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
    dt = st["cam_C"].dtype
    A = len(archive)
    cam_C, cam_q, cam_K = st["cam_C"][:n_live], st["cam_q"][:n_live], st["K"][:n_live]
    arc = _stack_archive(archive)
    if A:
        cam_C = np.concatenate([arc.C, cam_C])
        cam_q = np.concatenate([arc.q, cam_q])
        cam_K = np.concatenate([arc.K, cam_K])
    F = A + n_live

    # observation union (cam, gid, uv)
    cams, gids, uvs = [], [], []
    if A:
        v = arc.valid
        cams.append(np.repeat(np.arange(A, dtype=np.int32), v.sum(axis=1)))
        gids.append(arc.gid[v])
        uvs.append(arc.uv[v])
    lv = st["obs_valid"]
    cams.append(st["obs_cam"][lv].astype(np.int32) + A)
    gids.append(st["pt_gid"][st["obs_pt"][lv]])
    uvs.append(st["obs_uv"][lv])
    cam, gid, uv = np.concatenate(cams), np.concatenate(gids), np.concatenate(uvs)

    # global ids with enough support
    uniq, counts = np.unique(gid[gid >= 0], return_counts=True)
    sel = uniq[counts >= min_obs]
    max_track = int(counts[counts >= min_obs].max()) if sel.size else 0
    P_real = int(sel.size)
    idx = np.clip(np.searchsorted(sel, gid), 0, max(P_real - 1, 0))
    keep = np.logical_and(gid >= 0, sel[idx] == gid) if P_real else np.zeros(gid.shape, bool)
    cam, uv, pt_idx = cam[keep], uv[keep], idx[keep]
    O_real = int(cam.shape[0])

    # point seeds: archived in eviction order (numpy keeps the LAST write of
    # duplicate indices, so later evictions win), then the live map
    X_seed = np.zeros((max(P_real, 1), 3), dt)
    if A:
        v = arc.valid
        g = arc.gid[v]
        j = np.clip(np.searchsorted(sel, g), 0, max(P_real - 1, 0))
        ok = sel[j] == g if P_real else np.zeros(g.shape, bool)
        X_seed[j[ok]] = arc.X[v][ok]
    live = st["pt_valid"]
    g = st["pt_gid"][live]
    j = np.clip(np.searchsorted(sel, np.clip(g, 0, None)), 0, max(P_real - 1, 0))
    ok = np.logical_and(g >= 0, sel[j] == g) if P_real else np.zeros(g.shape, bool)
    X_seed[j[ok]] = st["points"][live][ok]

    # normalise pixels with each camera's own K
    Kinv = np.linalg.inv(cam_K)
    uvh = np.concatenate([uv, np.ones((O_real, 1), dt)], axis=1)
    uvn = np.einsum("oij,oj->oi", Kinv[cam], uvh)[:, :2].astype(dt)

    P_pad, O_pad = _round_up(P_real, pad_multiple), _round_up(O_real, pad_multiple)
    dev = state.points.device
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    ba_state = BAState(
        C=t(cam_C),
        q=t(cam_q),
        X=t(np.concatenate([X_seed[:P_real], np.zeros((P_pad - P_real, 3), dt)])),
        cam_valid=t(np.ones((F,), bool)),
        pt_valid=t(np.arange(P_pad) < P_real),
    )
    pad_i = np.zeros(O_pad - O_real, np.int32)
    obs = BAObservations(
        cam=t(np.concatenate([cam, pad_i])),
        point=t(np.concatenate([pt_idx.astype(np.int32), pad_i])),
        uv_norm=t(np.concatenate([uvn, np.zeros((O_pad - O_real, 2), dt)])),
        valid=t(np.arange(O_pad) < O_real),
    )
    gids_out = np.full((P_pad,), -1, np.int64)
    gids_out[:P_real] = sel
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


def pack_tiered(obs: BAObservations, tiers: tuple, order: np.ndarray,
                align: int = 512) -> BAObservations:
    """Host-side packing into the tiered-ELL layout. ``order``: original id
    of each renumbered point row (descending track length); tier t owns the
    next ``n_t`` points x ``rows_t`` slots; the stream is padded to an
    ``align`` multiple. Returns tensors on ``obs``'s device."""
    point, cam, uv, valid = (a.detach().cpu().numpy() for a in
                             (obs.point, obs.cam, obs.uv_norm, obs.valid))
    newid = np.empty(order.size, np.int64)
    newid[order] = np.arange(order.size)
    base = np.empty(order.size, np.int64)
    p0, s0 = 0, 0
    for n, r in tiers:
        base[p0:p0 + n] = s0 + np.arange(n, dtype=np.int64) * r
        p0 += n
        s0 += n * r
    total = s0 + (-s0) % align

    np_v = newid[point[valid]]
    o2 = np.argsort(np_v, kind="stable")
    np_s = np_v[o2]
    rank = np.arange(np_s.size) - np.searchsorted(np_s, np_s)
    dest = base[np_s] + rank

    cam_t = np.zeros(total, np.int32)
    uv_t = np.zeros((total, 2), uv.dtype)
    val_t = np.zeros(total, bool)
    pt_t = np.zeros(total, np.int32)
    p0, s0 = 0, 0
    for n, r in tiers:
        pt_t[s0:s0 + n * r] = np.repeat(np.arange(p0, p0 + n, dtype=np.int32), r)
        p0 += n
        s0 += n * r
    cam_t[dest] = cam[valid][o2]
    uv_t[dest] = uv[valid][o2]
    val_t[dest] = True
    dev = obs.cam.device
    return BAObservations(*(torch.as_tensor(a).to(dev) for a in (cam_t, pt_t, uv_t, val_t)))


def tiered_problem(problem: GlobalProblem):
    """Renumber points by descending track length and pack the stream into
    tiers -> (state, obs, tiers, order, cam_rows); ``cam_rows`` sizes the
    camera-major view to the busiest camera from 64 cameras up."""
    point, cam, valid = (a.cpu().numpy() for a in
                         (problem.obs.point, problem.obs.cam, problem.obs.valid))
    V, M_pad = problem.state.C.shape[0], problem.state.X.shape[0]
    counts = np.bincount(point[valid], minlength=M_pad)
    order = np.argsort(-counts, kind="stable")
    tiers = choose_tiers(counts[order])
    obs_t = pack_tiered(problem.obs, tiers, order)
    idx = torch.as_tensor(order).to(problem.state.X.device)
    st = problem.state._replace(X=problem.state.X[idx], pt_valid=problem.state.pt_valid[idx])
    cam_max = int(np.bincount(cam[valid], minlength=V).max())
    cam_rows = _round_up(cam_max, 8) if V >= 64 else 0
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
    ``global.pack`` (the layout, with its uploads), ``global.lm`` (the LM
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
        inv = torch.as_tensor(np.argsort(order)).to(out.X.device)
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
        point, cam, valid = (a.cpu().numpy() for a in
                             (problem.obs.point, problem.obs.cam, problem.obs.valid))
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
