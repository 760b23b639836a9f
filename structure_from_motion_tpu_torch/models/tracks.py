"""Device-resident track table, map and observation store (port of
``structure_from_motion_tpu/models/tracks.py``).

:class:`SfMState` is a ``NamedTuple`` of tensors with the JAX package's field
names, shapes and dtypes (0-dim int32 tensors for the counters). Every
helper returns a NEW state and leaves its input untouched (the stages rely
on that, e.g. the bootstrap evaluates two draws on the same input state).
JAX's ``mode="drop"`` scatters become writes into a buffer with one extra
dump row that is sliced off afterwards, so masked writes vanish and an
overflowing capacity is counted, never an index error.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_from_motion_tpu_torch.config import CapacityConfig
from structure_from_motion_tpu_torch.device import DTYPE
from structure_from_motion_tpu_torch.ops.reproj import pixel_residuals


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


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def _set_drop(t: torch.Tensor, dest: torch.Tensor, vals) -> torch.Tensor:
    """``t.at[dest].set(vals, mode="drop")`` for ``dest`` in [0, len(t)]:
    index ``len(t)`` is the dump row."""
    buf = torch.cat([t, t[:1]])
    buf[dest] = torch.as_tensor(vals, dtype=t.dtype, device=t.device)
    return buf[:-1]


def init_state(cap: CapacityConfig, K, desc_dim: int = 128, *, device="cuda",
               dtype=DTYPE) -> SfMState:
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


def _set_row(t: torch.Tensor, v: int, val) -> torch.Tensor:
    out = t.clone()
    out[v] = torch.as_tensor(val, dtype=t.dtype, device=t.device)
    return out


def set_view_features(state: SfMState, v: int, xy, desc, valid) -> SfMState:
    """Store one view's fixed-size keypoint buffers at row ``v``."""
    return state._replace(
        kp_xy=_set_row(state.kp_xy, v, xy),
        kp_desc=_set_row(state.kp_desc, v, desc),
        kp_valid=_set_row(state.kp_valid, v, valid),
    )


def record_matches(state: SfMState, u, v: int, target, valid) -> SfMState:
    """``match_table[u, v, k] = target[k]`` and the inverse row
    ``match_table[v, u, target[k]] = k`` where valid. ``u`` may be an int
    (target (K,)) or a (B,) tensor of view ids (target (B, K)), which writes
    every pair in one pass."""
    tbl = state.match_table
    u = torch.as_tensor(u, dtype=torch.long, device=tbl.device)
    target, valid = torch.atleast_2d(target), torch.atleast_2d(valid)
    Kk = target.shape[-1]
    fwd = torch.where(valid, target, -1).to(torch.int32)
    ks = torch.arange(Kk, dtype=torch.int32, device=tbl.device).expand_as(fwd)
    inv = torch.full((fwd.shape[0], Kk + 1), -1, dtype=torch.int32, device=tbl.device)
    inv.scatter_(1, torch.where(valid, target, Kk).long(), ks)
    tbl = tbl.clone()
    tbl[u.reshape(-1), v] = fwd
    tbl[v, u.reshape(-1)] = inv[:, :Kk]
    return state._replace(match_table=tbl)


def set_view_K(state: SfMState, v: int, K) -> SfMState:
    return state._replace(K=_set_row(state.K, v, K))


def set_camera(state: SfMState, v: int, C, q) -> SfMState:
    return state._replace(
        cam_C=_set_row(state.cam_C, v, C),
        cam_q=_set_row(state.cam_q, v, q),
        cam_valid=_set_row(state.cam_valid, v, True),
    )


def allocate_points(state: SfMState, X: torch.Tensor, mask: torch.Tensor):
    """Append masked new points. Returns (state, ids (N,) int32, stored (N,)
    bool); ``stored`` is ``mask`` minus capacity overflow (counted in
    ``dropped_points``), and every later recording must gate on it."""
    ranks = torch.cumsum(mask.to(torch.int32), 0) - 1
    ids = state.num_points + ranks
    M = state.points.shape[0]
    stored = mask & (ids < M)
    dest = torch.where(stored, ids, M).long()
    n_new = mask.sum(dtype=torch.int32)
    kept = stored.sum(dtype=torch.int32)
    state = state._replace(
        points=_set_drop(state.points, dest, X),
        pt_valid=_set_drop(state.pt_valid, dest, stored),
        pt_gid=_set_drop(state.pt_gid, dest, state.next_gid + ranks),
        next_gid=_i32(state.next_gid + n_new),
        num_points=_i32(torch.clamp(state.num_points + n_new, max=M)),
        dropped_points=_i32(state.dropped_points + n_new - kept),
    )
    return state, ids.to(torch.int32), stored


def set_tri_index(state: SfMState, v: int, keys, ids, mask) -> SfMState:
    """``tri_index[v, keys] = ids`` where mask."""
    Kk = state.tri_index.shape[1]
    row = _set_drop(
        state.tri_index[v], torch.where(mask, keys, Kk).long(), torch.where(mask, ids, -1)
    )
    return state._replace(tri_index=_set_row(state.tri_index, v, row))


def set_tri_index_flat(state: SfMState, views, keys, ids, mask) -> SfMState:
    """``tri_index[views, keys] = ids`` where mask (views spanning many rows)."""
    V, Kk = state.tri_index.shape
    flat = torch.where(mask, views.long() * Kk + keys.long(), V * Kk)
    tri = _set_drop(state.tri_index.reshape(-1), flat, torch.where(mask, ids, -1))
    return state._replace(tri_index=tri.view(V, Kk))


def append_observations(state: SfMState, cam, point, uv, mask) -> SfMState:
    """Append masked observations (capacity-bounded; overflow is counted in
    ``dropped_obs``)."""
    O = state.obs_cam.shape[0]
    ranks = torch.cumsum(mask.to(torch.int32), 0) - 1
    dest = torch.where(mask, state.num_obs + ranks, O).clamp(max=O)
    kept = mask & (dest < O)
    dest = dest.long()
    n_dropped = mask.sum(dtype=torch.int32) - kept.sum(dtype=torch.int32)
    return state._replace(
        obs_cam=_set_drop(state.obs_cam, dest, cam),
        obs_pt=_set_drop(state.obs_pt, dest, point),
        obs_uv=_set_drop(state.obs_uv, dest, uv),
        obs_valid=_set_drop(state.obs_valid, dest, kept),
        num_obs=_i32(torch.clamp(state.num_obs + kept.sum(dtype=torch.int32), max=O)),
        dropped_obs=_i32(state.dropped_obs + n_dropped),
    )


def matched_pair_arrays(state: SfMState, u: int, v: int):
    """(ref_keys, que_keys, ref_xy, que_xy, valid) of views (u, v)."""
    Kk = state.match_table.shape[2]
    tgt = state.match_table[u, v]
    valid = tgt >= 0
    ref_keys = torch.arange(Kk, dtype=torch.int32, device=tgt.device)
    que_keys = torch.where(valid, tgt, 0)
    return ref_keys, que_keys, state.kp_xy[u], state.kp_xy[v][que_keys.long()], valid


def compact_state(state: SfMState) -> SfMState:
    """Stable-compact the point and observation stores and remap every
    ``tri_index``/``obs_pt`` reference (used by :func:`prune_observations`
    and :func:`evict_oldest_view`)."""
    M = state.points.shape[0]
    O = state.obs_cam.shape[0]
    pt_valid = state.pt_valid
    new_id = torch.cumsum(pt_valid.to(torch.int32), 0) - 1
    dest_pt = torch.where(pt_valid, new_id, M).long()
    remap = torch.where(pt_valid, new_id, -1)
    tri = state.tri_index
    tri_index = torch.where(tri >= 0, remap[tri.clamp_min(0).long()], -1)
    obs_remap = remap[state.obs_pt.long()]
    keep_obs = state.obs_valid & (obs_remap >= 0)
    dest_o = torch.where(keep_obs, torch.cumsum(keep_obs.to(torch.int32), 0) - 1, O).long()
    return state._replace(
        tri_index=tri_index.to(torch.int32),
        points=_set_drop(torch.zeros_like(state.points), dest_pt, state.points),
        pt_valid=_set_drop(torch.zeros_like(pt_valid), dest_pt, pt_valid),
        pt_gid=_set_drop(torch.full_like(state.pt_gid, -1), dest_pt, state.pt_gid),
        num_points=pt_valid.sum(dtype=torch.int32),
        obs_cam=_set_drop(torch.zeros_like(state.obs_cam), dest_o, state.obs_cam),
        obs_pt=_set_drop(torch.zeros_like(state.obs_pt), dest_o, obs_remap),
        obs_uv=_set_drop(torch.zeros_like(state.obs_uv), dest_o, state.obs_uv),
        obs_valid=_set_drop(torch.zeros_like(state.obs_valid), dest_o, keep_obs),
        num_obs=keep_obs.sum(dtype=torch.int32),
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


def _shift0(x: torch.Tensor, fill) -> torch.Tensor:
    """Drop row 0, shift every row down by one, fill the last row."""
    return torch.cat([x[1:], torch.full_like(x[:1], fill)])


def evict_oldest_view(state: SfMState):
    """Slide the window: drop view 0 and shift every view down by one (the
    "prior views have smaller indices" invariant every stage relies on).
    Returns (state, :class:`EvictionRecord`): the evicted view's
    observations are archived, then dropped; points left with no
    observation die; the stores are compacted and every reference
    remapped."""
    V, Kk = state.tri_index.shape
    M = state.points.shape[0]
    ev_mask = state.obs_valid & (state.obs_cam == 0)
    ev_rank = torch.cumsum(ev_mask.to(torch.int32), 0) - 1
    ev_dst = torch.where(ev_mask, ev_rank.clamp(max=Kk), Kk).long()  # Kk drops
    pt = state.obs_pt.long()
    dev = state.points.device
    rec = EvictionRecord(
        C=state.cam_C[0].clone(),
        q=state.cam_q[0].clone(),
        K=state.K[0].clone(),
        gid=_set_drop(torch.full((Kk,), -1, dtype=torch.int32, device=dev), ev_dst,
                      state.pt_gid[pt]),
        uv=_set_drop(torch.zeros((Kk, 2), dtype=state.obs_uv.dtype, device=dev), ev_dst,
                     state.obs_uv),
        X=_set_drop(torch.zeros((Kk, 3), dtype=state.points.dtype, device=dev), ev_dst,
                    state.points[pt]),
        valid=_set_drop(torch.zeros(Kk, dtype=torch.bool, device=dev), ev_dst, ev_mask),
    )
    # the vacated last slot inherits the newest K (overwritten when the next
    # frame brings its own)
    K_rows = torch.cat([state.K[1:], state.K[-1:]])
    match_table = torch.full_like(state.match_table, -1)
    match_table[: V - 1, : V - 1] = state.match_table[1:, 1:]
    keep_obs = state.obs_valid & (state.obs_cam != 0)
    counts = torch.zeros(M, dtype=torch.int32, device=dev)
    counts.index_add_(0, torch.where(keep_obs, pt, M - 1), keep_obs.to(torch.int32))
    cam_q = torch.cat([state.cam_q[1:], state.cam_q.new_tensor([[1.0, 0, 0, 0]])])
    state = state._replace(
        kp_xy=_shift0(state.kp_xy, 0),
        kp_desc=_shift0(state.kp_desc, 0),
        kp_valid=_shift0(state.kp_valid, False),
        match_table=match_table,
        tri_index=_shift0(state.tri_index, -1),
        cam_C=_shift0(state.cam_C, 0),
        cam_q=cam_q,
        cam_valid=_shift0(state.cam_valid, False),
        pt_valid=state.pt_valid & (counts > 0),
        obs_cam=(state.obs_cam - 1).to(torch.int32),
        obs_valid=keep_obs,
        K=K_rows,
    )
    return compact_state(state), rec


def prune_observations(state: SfMState, max_err_px: float):
    """Drop observations with pixel reprojection error above ``max_err_px``
    (or non-positive depth), kill points left with < 2 observations, and
    compact. Returns (state, num_dropped_obs, num_dropped_points)."""
    cam, pt = state.obs_cam.long(), state.obs_pt.long()
    res, depth = pixel_residuals(
        state.K[cam], state.cam_C[cam], state.cam_q[cam], state.points[pt], state.obs_uv
    )
    err = torch.linalg.norm(res, dim=-1)
    keep = state.obs_valid & (err <= max_err_px) & (depth > 0)
    n_dropped = state.obs_valid.sum(dtype=torch.int32) - keep.sum(dtype=torch.int32)
    M = state.points.shape[0]
    counts = torch.zeros(M, dtype=torch.int32, device=pt.device)
    counts.index_add_(0, torch.where(keep, pt, M - 1), keep.to(torch.int32))
    pt_valid = state.pt_valid & (counts >= 2)
    n_pts = state.pt_valid.sum(dtype=torch.int32) - pt_valid.sum(dtype=torch.int32)
    state = compact_state(state._replace(obs_valid=keep, pt_valid=pt_valid))
    return state, n_dropped, n_pts
