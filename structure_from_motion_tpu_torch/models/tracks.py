"""Device-resident track table, map and observation store (port of
``structure_from_motion_tpu/models/tracks.py``).

:class:`SfMState` is a ``NamedTuple`` of tensors with the JAX package's field
names, shapes and dtypes (0-dim int32 tensors for the counters). Every
helper returns a NEW state and leaves its input untouched (the stages rely
on that, e.g. the bootstrap evaluates two draws on the same input state).
JAX's ``mode="drop"`` scatters become writes into a buffer with one extra
dump row that is sliced off afterwards, so masked writes vanish and an
overflowing capacity is counted, never an index error.

The helpers are written once, for a lane stack: every field with a leading
lane axis ((B, V, K, 2) keypoints, (B,) counters), each lane its own store,
as the batched engine holds it (the JAX package ``vmap``s one copy).
:func:`lanewise` lets each of them take one state as it is, lifted to a
stack of one lane, and hands back its results without the lane axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from structure_from_motion_tpu_torch.config import CapacityConfig
from structure_from_motion_tpu_torch.device import DTYPE, HostCopy
from structure_from_motion_tpu_torch.ops.reproj import pixel_residuals
from structure_from_motion_tpu_torch.utils.control import put, take


class SfMState(NamedTuple):
    kp_xy: torch.Tensor  # (V, K, 2) f32
    kp_desc: torch.Tensor  # (V, K, D) f32
    kp_valid: torch.Tensor  # (V, K) bool
    match_table: torch.Tensor  # (V, V, K) int32
    tri_index: torch.Tensor  # (V, K) int32
    cam_C: torch.Tensor  # (V, 3)
    cam_q: torch.Tensor  # (V, 4)
    cam_valid: torch.Tensor  # (V,) bool
    points: torch.Tensor  # (M, 3)
    pt_valid: torch.Tensor  # (M,) bool
    num_points: torch.Tensor  # () int32
    obs_cam: torch.Tensor  # (O,) int32
    obs_pt: torch.Tensor  # (O,) int32
    obs_uv: torch.Tensor  # (O, 2)
    obs_valid: torch.Tensor  # (O,) bool
    num_obs: torch.Tensor  # () int32
    dropped_points: torch.Tensor  # () int32
    dropped_obs: torch.Tensor  # () int32
    pt_gid: torch.Tensor  # (M,) int32
    next_gid: torch.Tensor  # () int32
    K: torch.Tensor  # (V, 3, 3)


def lanes_of(state):
    """One state (or record) as a stack of one lane: a view, no copy."""
    return type(state)(*(t[None] for t in state))


def lane_state(state, b: int):
    """Lane ``b`` of a lane-stacked state (or record), as one engine holds it."""
    return type(state)(*(t[b] for t in state))


def _drop_lane(x):
    if torch.is_tensor(x):
        return x[0]
    if isinstance(x, tuple):
        items = [_drop_lane(y) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def lanewise(fn):
    """Let ``fn(state, *args)``, written for a lane-stacked state, take one
    state too: it and every tensor argument gain a lane axis of one, and
    every tensor ``fn`` returns loses it again."""

    @functools.wraps(fn)
    def wrapper(state, *args, **kwargs):
        if state.num_points.dim():
            return fn(state, *args, **kwargs)
        # a 0-dim tensor is a slot index (``v``), shared by the lanes
        lift = lambda a: a[None] if torch.is_tensor(a) and a.dim() else a  # noqa: E731
        return _drop_lane(fn(lanes_of(state), *map(lift, args), **kwargs))

    return wrapper


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _lane(B: int, device) -> torch.Tensor:
    """(B, 1) lane index: ``t[_lane(B), idx]`` gathers lane b's rows idx[b]."""
    return torch.arange(B, device=device)[:, None]


def _set_drop(t: torch.Tensor, dest: torch.Tensor, vals) -> torch.Tensor:
    """Lane-wise ``t[b].at[dest[b]].set(vals[b], mode="drop")``: ``dest``
    (B, n) in [0, N] with index N each lane's dump row."""
    buf = torch.cat([t, t[:, :1]], dim=1)
    if torch.is_tensor(vals):
        vals = vals.to(t.dtype)
    buf[_lane(t.shape[0], t.device), dest] = vals
    return buf[:, :-1]


def init_state(cap: CapacityConfig, K, desc_dim: int = 128, *, device="cuda",
               dtype=DTYPE) -> SfMState:
    """One empty store (no lane axis)."""
    V, Kk, M, O = cap.max_views, cap.max_keypoints, cap.max_points, cap.max_observations
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    K = torch.as_tensor(K, dtype=dtype, device=device)
    return SfMState(
        kp_xy=z(V, Kk, 2),
        kp_desc=z(V, Kk, desc_dim),
        kp_valid=z(V, Kk, dt=torch.bool),
        match_table=torch.full((V, V, Kk), -1, dtype=torch.int32, device=device),
        tri_index=torch.full((V, Kk), -1, dtype=torch.int32, device=device),
        cam_C=z(V, 3),
        cam_q=torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device).repeat(V, 1),
        cam_valid=z(V, dt=torch.bool),
        points=z(M, 3),
        pt_valid=z(M, dt=torch.bool),
        num_points=i32(0),
        obs_cam=z(O, dt=torch.int32),
        obs_pt=z(O, dt=torch.int32),
        obs_uv=z(O, 2),
        obs_valid=z(O, dt=torch.bool),
        num_obs=i32(0),
        dropped_points=i32(0),
        dropped_obs=i32(0),
        pt_gid=torch.full((M,), -1, dtype=torch.int32, device=device),
        next_gid=i32(0),
        K=K.expand(V, 3, 3).clone(),
    )


@lanewise
def set_view_features(state: SfMState, v: int, xy, desc, valid) -> SfMState:
    """Store every lane's fixed-size keypoint buffers at row ``v``."""
    return state._replace(kp_xy=put(state.kp_xy, v, xy, 1),
                          kp_desc=put(state.kp_desc, v, desc, 1),
                          kp_valid=put(state.kp_valid, v, valid, 1))


@lanewise
def record_matches(state: SfMState, v: int, target, valid) -> SfMState:
    """View v against every view u at once: ``match_table[u, v, k] =
    target[u, k]`` and the inverse rows ``match_table[v, u, target[u, k]] =
    k`` where valid (``target``, ``valid`` (V, K) a lane)."""
    tbl = state.match_table
    Kk = target.shape[-1]
    fwd = torch.where(valid, target, -1).to(torch.int32)
    ks = torch.arange(Kk, dtype=torch.int32, device=tbl.device).expand_as(fwd)
    inv = torch.full(fwd.shape[:-1] + (Kk + 1,), -1, dtype=torch.int32, device=tbl.device)
    inv.scatter_(-1, torch.where(valid, target, Kk).long(), ks)
    tbl = put(tbl, v, fwd, 2)
    return state._replace(match_table=put(tbl, v, inv[..., :Kk], 1))


@lanewise
def set_view_K(state: SfMState, v: int, K) -> SfMState:
    return state._replace(K=put(state.K, v, K, 1))


@lanewise
def set_camera(state: SfMState, v: int, C, q) -> SfMState:
    return state._replace(cam_C=put(state.cam_C, v, C, 1), cam_q=put(state.cam_q, v, q, 1),
                          cam_valid=put(state.cam_valid, v, True, 1))


@lanewise
def allocate_points(state: SfMState, X: torch.Tensor, mask: torch.Tensor):
    """Append each lane's masked new points. Returns (state, ids int32,
    stored bool), (n,) a lane; ``stored`` is ``mask`` minus capacity
    overflow (counted in ``dropped_points``), and every later recording
    must gate on it."""
    ranks = torch.cumsum(mask.to(torch.int32), 1) - 1
    ids = state.num_points[:, None] + ranks
    M = state.points.shape[1]
    stored = mask & (ids < M)
    dest = torch.where(stored, ids, M).long()
    n_new = mask.sum(1, dtype=torch.int32)
    kept = stored.sum(1, dtype=torch.int32)
    state = state._replace(
        points=_set_drop(state.points, dest, X),
        pt_valid=_set_drop(state.pt_valid, dest, stored),
        pt_gid=_set_drop(state.pt_gid, dest, state.next_gid[:, None] + ranks),
        next_gid=_i32(state.next_gid + n_new),
        num_points=_i32(torch.clamp(state.num_points + n_new, max=M)),
        dropped_points=_i32(state.dropped_points + n_new - kept),
    )
    return state, _i32(ids), stored


def _last_writers(dest: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """``mask`` kept only at the LAST masked position (in flat order) of each
    destination in [0, n) of a lane: the sequential last-writer result of a
    scatter with repeated keys, which a CUDA scatter does not promise (its
    writes race), as ONE write per key."""
    B, N = dest.shape
    ar = _lane(B, dest.device)
    order = torch.arange(N, device=dest.device).expand(B, N)
    key = torch.where(mask, dest, n) + ar * (n + 1)
    last = torch.full((B * (n + 1),), -1, dtype=torch.long, device=dest.device)
    last.scatter_reduce_(0, key.reshape(-1), torch.where(mask, order, -1).reshape(-1), "amax")
    return mask & (last[key] == order)


@lanewise
def set_tri_index(state: SfMState, v: int, keys, ids, mask) -> SfMState:
    """``tri_index[v, keys] = ids`` where mask; of several masked writes to
    one key the last (in flat order) wins, on every device."""
    Kk = state.tri_index.shape[2]
    keys = keys.long()
    mask = _last_writers(keys, mask, Kk)
    row = _set_drop(take(state.tri_index, v, 1), torch.where(mask, keys, Kk),
                    torch.where(mask, ids, -1))
    return state._replace(tri_index=put(state.tri_index, v, row, 1))


@lanewise
def set_tri_index_flat(state: SfMState, views, keys, ids, mask) -> SfMState:
    """``tri_index[views, keys] = ids`` where mask (views spanning many rows);
    the last of several masked writes to one entry wins."""
    B, V, Kk = state.tri_index.shape
    flat = views.long() * Kk + keys.long()
    mask = _last_writers(flat, mask, V * Kk)
    tri = _set_drop(state.tri_index.reshape(B, -1), torch.where(mask, flat, V * Kk),
                    torch.where(mask, ids, -1))
    return state._replace(tri_index=tri.view(B, V, Kk))


@lanewise
def append_observations(state: SfMState, cam, point, uv, mask) -> SfMState:
    """Append masked observations (capacity-bounded; overflow is counted in
    ``dropped_obs``)."""
    O = state.obs_cam.shape[1]
    ranks = torch.cumsum(mask.to(torch.int32), 1) - 1
    dest = torch.where(mask, state.num_obs[:, None] + ranks, O).clamp(max=O)
    kept = mask & (dest < O)
    dest = dest.long()
    n_dropped = mask.sum(1, dtype=torch.int32) - kept.sum(1, dtype=torch.int32)
    return state._replace(
        obs_cam=_set_drop(state.obs_cam, dest, cam),
        obs_pt=_set_drop(state.obs_pt, dest, point),
        obs_uv=_set_drop(state.obs_uv, dest, uv),
        obs_valid=_set_drop(state.obs_valid, dest, kept),
        num_obs=_i32(torch.clamp(state.num_obs + kept.sum(1, dtype=torch.int32), max=O)),
        dropped_obs=_i32(state.dropped_obs + n_dropped),
    )


@lanewise
def matched_pair_arrays(state: SfMState, u: int, v: int):
    """(ref_keys, que_keys, ref_xy, que_xy, valid) of views (u, v)."""
    B, Kk = state.match_table.shape[0], state.match_table.shape[-1]
    tgt = state.match_table[:, u, v]
    valid = tgt >= 0
    ref_keys = torch.arange(Kk, dtype=torch.int32, device=tgt.device).expand(B, Kk)
    que_keys = torch.where(valid, tgt, 0)
    que_xy = take(state.kp_xy, v, 1)[_lane(B, tgt.device), que_keys.long()]
    return ref_keys, que_keys, take(state.kp_xy, u, 1), que_xy, valid


@lanewise
def compact_state(state: SfMState) -> SfMState:
    """Stable-compact the point and observation stores and remap every
    ``tri_index``/``obs_pt`` reference (used by :func:`prune_observations`
    and :func:`evict_oldest_view`)."""
    B, M = state.points.shape[:2]
    O = state.obs_cam.shape[1]
    ar = _lane(B, state.points.device)
    pt_valid = state.pt_valid
    new_id = torch.cumsum(pt_valid.to(torch.int32), 1) - 1
    dest_pt = torch.where(pt_valid, new_id, M).long()
    remap = torch.where(pt_valid, new_id, -1)
    tri = state.tri_index
    tri_index = torch.where(tri >= 0, remap[ar[:, :, None], tri.clamp_min(0).long()], -1)
    obs_remap = remap[ar, state.obs_pt.long()]
    keep_obs = state.obs_valid & (obs_remap >= 0)
    dest_o = torch.where(keep_obs, torch.cumsum(keep_obs.to(torch.int32), 1) - 1, O).long()
    return state._replace(
        tri_index=tri_index.to(torch.int32),
        points=_set_drop(torch.zeros_like(state.points), dest_pt, state.points),
        pt_valid=_set_drop(torch.zeros_like(pt_valid), dest_pt, pt_valid),
        pt_gid=_set_drop(torch.full_like(state.pt_gid, -1), dest_pt, state.pt_gid),
        num_points=pt_valid.sum(1, dtype=torch.int32),
        obs_cam=_set_drop(torch.zeros_like(state.obs_cam), dest_o, state.obs_cam),
        obs_pt=_set_drop(torch.zeros_like(state.obs_pt), dest_o, obs_remap),
        obs_uv=_set_drop(torch.zeros_like(state.obs_uv), dest_o, state.obs_uv),
        obs_valid=_set_drop(torch.zeros_like(state.obs_valid), dest_o, keep_obs),
        num_obs=keep_obs.sum(1, dtype=torch.int32),
    )


class EvictionRecord(NamedTuple):
    """What :func:`evict_oldest_view` keeps of the dropped view, enough to
    rebuild a whole-trajectory BA problem later: its pose, intrinsics, and
    its observations keyed by persistent global point id with each point's
    position at eviction. Fixed shape (keypoint capacity Kk). The engine
    keeps records as host numpy arrays."""

    C: torch.Tensor  # (3,)
    q: torch.Tensor  # (4,)
    K: torch.Tensor  # (3, 3)
    gid: torch.Tensor  # (Kk,) int32 global point id per observation (-1 empty)
    uv: torch.Tensor  # (Kk, 2) pixel coordinates in the evicted view
    X: torch.Tensor  # (Kk, 3) observed point's position at eviction
    valid: torch.Tensor  # (Kk,) bool


class EvictionArchive:
    """Slide mode's evicted views, oldest first, read as host-numpy
    :class:`EvictionRecord` s (indexing, iteration, ``len``). A record of
    device tensors (:meth:`append_device`) starts its host copy at once
    (:class:`~..device.HostCopy`: non-blocking, one event) and becomes a
    numpy record the first time anything reads it, so a slide frame does
    not wait for its eviction record (the JAX package's
    ``copy_to_host_async``)."""

    def __init__(self, records=()):
        self._items = list(records)

    def append_device(self, record: EvictionRecord) -> None:
        """Append a record of tensors, copied to the host in the background."""
        self._items.append(HostCopy(record))

    def _get(self, i: int) -> EvictionRecord:
        item = self._items[i]
        if isinstance(item, HostCopy):
            item = self._items[i] = EvictionRecord(*item.arrays())
        return item

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._get(j) for j in range(len(self))[i]]
        return self._get(i)

    def __iter__(self):
        return (self._get(i) for i in range(len(self)))


def _shift0(x: torch.Tensor, fill) -> torch.Tensor:
    """Drop row 0 of every lane, shift every row down by one, fill the last."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _lane_counts(pt: torch.Tensor, keep: torch.Tensor, M: int) -> torch.Tensor:
    """(B, M) number of kept observations of each lane's points."""
    B = pt.shape[0]
    counts = torch.zeros(B * M, dtype=torch.int32, device=pt.device)
    idx = torch.where(keep, pt, M - 1) + _lane(B, pt.device) * M
    counts.index_add_(0, idx.reshape(-1), keep.to(torch.int32).reshape(-1))
    return counts.view(B, M)


@lanewise
def evict_oldest_view(state: SfMState):
    """Slide the window: drop view 0 and shift every view down by one (the
    "prior views have smaller indices" invariant every stage relies on).
    Returns (state, :class:`EvictionRecord`): the evicted view's
    observations are archived, then dropped; points left with no
    observation die; the stores are compacted and every reference
    remapped."""
    B, V, Kk = state.tri_index.shape
    M = state.points.shape[1]
    dev = state.points.device
    ar = _lane(B, dev)
    ev_mask = state.obs_valid & (state.obs_cam == 0)
    ev_rank = torch.cumsum(ev_mask.to(torch.int32), 1) - 1
    ev_dst = torch.where(ev_mask, ev_rank.clamp(max=Kk), Kk).long()  # Kk drops
    pt = state.obs_pt.long()
    rec = EvictionRecord(
        C=state.cam_C[:, 0].clone(),
        q=state.cam_q[:, 0].clone(),
        K=state.K[:, 0].clone(),
        gid=_set_drop(torch.full((B, Kk), -1, dtype=torch.int32, device=dev), ev_dst,
                      state.pt_gid[ar, pt]),
        uv=_set_drop(torch.zeros((B, Kk, 2), dtype=state.obs_uv.dtype, device=dev), ev_dst,
                     state.obs_uv),
        X=_set_drop(torch.zeros((B, Kk, 3), dtype=state.points.dtype, device=dev), ev_dst,
                    state.points[ar, pt]),
        valid=_set_drop(torch.zeros((B, Kk), dtype=torch.bool, device=dev), ev_dst, ev_mask),
    )
    match_table = torch.full_like(state.match_table, -1)
    match_table[:, : V - 1, : V - 1] = state.match_table[:, 1:, 1:]
    keep_obs = state.obs_valid & (state.obs_cam != 0)
    counts = _lane_counts(pt, keep_obs, M)
    ident = torch.zeros_like(state.cam_q[:, :1])  # (1, 0, 0, 0) made on the device
    ident[..., 0] = 1.0
    state = state._replace(
        kp_xy=_shift0(state.kp_xy, 0),
        kp_desc=_shift0(state.kp_desc, 0),
        kp_valid=_shift0(state.kp_valid, False),
        match_table=match_table,
        tri_index=_shift0(state.tri_index, -1),
        cam_C=_shift0(state.cam_C, 0),
        cam_q=torch.cat([state.cam_q[:, 1:], ident], dim=1),
        cam_valid=_shift0(state.cam_valid, False),
        pt_valid=state.pt_valid & (counts > 0),
        obs_cam=_i32(state.obs_cam - 1),
        obs_valid=keep_obs,
        # the vacated last slot inherits the newest K (overwritten when the
        # next frame brings its own)
        K=torch.cat([state.K[:, 1:], state.K[:, -1:]], dim=1),
    )
    return compact_state(state), rec


def _obs_residuals(state: SfMState):
    """Pixel residuals and depths of every lane's observation store."""
    ar = _lane(state.obs_cam.shape[0], state.obs_cam.device)
    cam, pt = state.obs_cam.long(), state.obs_pt.long()
    return pixel_residuals(state.K[ar, cam], state.cam_C[ar, cam], state.cam_q[ar, cam],
                           state.points[ar, pt], state.obs_uv)


@lanewise
def prune_observations(state: SfMState, max_err_px: float):
    """Drop observations with pixel reprojection error above ``max_err_px``
    (or non-positive depth), kill points left with < 2 observations, and
    compact. Returns (state, num_dropped_obs, num_dropped_points)."""
    res, depth = _obs_residuals(state)
    keep = state.obs_valid & (torch.linalg.norm(res, dim=-1) <= max_err_px) & (depth > 0)
    n_dropped = state.obs_valid.sum(1, dtype=torch.int32) - keep.sum(1, dtype=torch.int32)
    counts = _lane_counts(state.obs_pt.long(), keep, state.points.shape[1])
    pt_valid = state.pt_valid & (counts >= 2)
    n_pts = state.pt_valid.sum(1, dtype=torch.int32) - pt_valid.sum(1, dtype=torch.int32)
    state = compact_state(state._replace(obs_valid=keep, pt_valid=pt_valid))
    return state, n_dropped, n_pts


@lanewise
def reprojection_error(state: SfMState) -> torch.Tensor:
    """Mean pixel reprojection error over the valid observations."""
    res, _ = _obs_residuals(state)
    w = state.obs_valid.to(res.dtype)
    err = torch.linalg.norm(res * w[..., None], dim=-1)
    return err.sum(1) / w.sum(1).clamp_min(1.0)
