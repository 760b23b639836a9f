"""The flagship model: incremental Structure-from-Motion (port of
``structure_from_motion_tpu/models/incremental.py``).

Same stages over the same fixed-capacity :class:`SfMState`: frame 0 pins
view 0 at the origin, frame 1 bootstraps from two views (two F draws, the
one with more parallax-clearing points wins), later frames localise by PnP
against the union of all prior views' 2D-3D matches, triangulate every new
match, run bundle adjustment and prune.

The JAX package fuses a frame into one jitted program and picks buckets on
device with ``lax.switch``; here the code runs eagerly, so each bucketed
stage makes ONE host read of its live counts and runs at the smallest
power-of-two bucket that holds them (the same ladders, so the set of shapes
stays small). The ``lax.map`` over prior views in the match stage is one
batched call: all views' descriptors go through kernel B3 in one launch and
the F-gate RANSAC carries a leading view axis. Random draws come from
``torch.Generator``s seeded from ``(seed, frame, stream)``.

``window_mode="slide"`` evicts the oldest view once the window is full and
keeps its record on the host; :meth:`IncrementalSfM.finalize_global` solves
the whole trajectory from that archive plus the live window
(``models/global_ba.py``), and checkpoints use the JAX package's npz
layout. Not ported yet (they raise): keyframe gating, lens distortion and
sharded BA.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from structure_from_motion_tpu.config import PipelineConfig
from structure_from_motion_tpu_torch.device import generator, stable_topk
from structure_from_motion_tpu_torch.models import global_ba, tracks
from structure_from_motion_tpu_torch.models.tracks import SfMState
from structure_from_motion_tpu_torch.ops.ba import BAObservations, BAState, run_bundle_adjustment
from structure_from_motion_tpu_torch.ops.campose import (
    candidate_projections,
    decompose_essential,
    disambiguate_poses,
    refine_relative_pose,
)
from structure_from_motion_tpu_torch.ops.epipolar import (
    essential_from_fundamental,
    find_fundamental,
)
from structure_from_motion_tpu_torch.ops.features import detect_and_describe
from structure_from_motion_tpu_torch.ops.matching import match_descriptors
from structure_from_motion_tpu_torch.ops.pnp import PnPResult, estimate_pnp
from structure_from_motion_tpu_torch.ops.ransac import sample_index_sets
from structure_from_motion_tpu_torch.ops.reproj import pixel_residuals
from structure_from_motion_tpu_torch.ops.triangulation import (
    linear_triangulate,
    refine_triangulate,
    reprojection_residuals,
    triangulate,
)
from structure_from_motion_tpu_torch.utils.geometry import (
    camera_projection,
    normalized_camera_coords,
    normalized_camera_coords_per_obs,
)
from structure_from_motion_tpu_torch.utils.rotations import quat_to_rotation, rotation_to_quat

# generator streams per frame: match-stage F-gate, then the stage's draws
_STREAM_MATCH, _STREAM_STAGE, _STREAM_STAGE_B = 0, 1, 2


def _match_stage(state: SfMState, v: int, gen: torch.Generator, config: PipelineConfig) -> SfMState:
    """Match view v against every prior view in one batched call (kernel B3
    over all views' reference rows), optionally gated per view by a
    fundamental-matrix RANSAC inlier test, and record the matches."""
    V = state.kp_desc.shape[0]
    prior = torch.arange(V, device=state.kp_desc.device) < v
    res = match_descriptors(
        state.kp_desc, state.kp_desc[v], state.kp_valid & prior[:, None],
        state.kp_valid[v], config.matcher,
    )
    valid = res.valid
    if config.matcher.use_fundamental_gate:
        rc = config.matcher.gate_ransac
        que_xy = state.kp_xy[v][res.target.clamp_min(0).long()]  # (V, K, 2)
        idx_sets = sample_index_sets(gen, valid, rc.num_hypotheses, 8)
        gate = find_fundamental(idx_sets, state.kp_xy, que_xy, valid, rc)
        # only gate views with enough matches for a meaningful model
        enough = valid.sum(-1, keepdim=True) >= 16
        valid = torch.where(enough, valid & gate.inliers, valid)
    return tracks.record_matches(
        state, torch.arange(V, device=valid.device), v, res.target, valid & prior[:, None]
    )


def _bootstrap_stage(state: SfMState, gen_a, gen_b, config: PipelineConfig):
    """Two-view bootstrap with two independent F draws; the draw with more
    admitted points that also clear the parallax threshold wins (one host
    read)."""
    st_a, info_a = _bootstrap_once(state, gen_a, config)
    st_b, info_b = _bootstrap_once(state, gen_b, config)
    if bool(info_b["parallax_ok"] > info_a["parallax_ok"]):
        st_a, info_a = st_b, info_b
    info_a.pop("parallax_ok")
    return st_a, info_a


def _bootstrap_once(state: SfMState, gen, config: PipelineConfig):
    ref_keys, que_keys, ref_xy, que_xy, valid = tracks.matched_pair_arrays(state, 0, 1)
    rc = config.fundamental_ransac
    F = find_fundamental(sample_index_sets(gen, valid, rc.num_hypotheses, 8),
                         ref_xy, que_xy, valid, rc)
    K0, K1 = state.K[0], state.K[1]
    cands = decompose_essential(essential_from_fundamental(F.F, K0, K1))
    P_ref = camera_projection(K0, quat_to_rotation(state.cam_q[0]), state.cam_C[0])
    P_cands = candidate_projections(K1, cands)
    uv = torch.stack([ref_xy, que_xy], dim=1)
    obs_mask = torch.stack([valid, valid], dim=1)
    X4 = torch.stack([linear_triangulate(torch.stack([P_ref, P2]), uv, obs_mask) for P2 in P_cands])
    best, counts, cheir_ok = disambiguate_poses(P_ref, P_cands, X4, valid)

    # essential-manifold refinement of the winning (R, t)
    R1, _, C1 = refine_relative_pose(
        cands.R[best], cands.t[best], normalized_camera_coords(K0, ref_xy),
        normalized_camera_coords(K1, que_xy), valid & F.inliers,
    )
    state = tracks.set_camera(state, 1, C1, rotation_to_quat(R1))
    P_pair = torch.stack([P_ref, camera_projection(K1, R1, C1)])
    X2 = linear_triangulate(P_pair, uv, obs_mask)
    Xh = refine_triangulate(P_pair, uv, torch.stack([cheir_ok, cheir_ok], dim=1), X2,
                            config.triangulation_lm)

    # admission: cheirality AND epipolar inlier AND two-view reprojection;
    # parallax only feeds the draw-selection metric
    res, _ = reprojection_residuals(P_pair, Xh[:, :3], uv, obs_mask)
    small = torch.linalg.norm(res, dim=-1).amax(1) < config.triangulation_max_error_px
    enough_parallax = _cos_parallax(Xh[:, :3], state.cam_C[0], C1) < math.cos(
        math.radians(config.min_parallax_deg))
    keep = cheir_ok & F.inliers & small
    state, ids, stored = tracks.allocate_points(state, Xh[:, :3], keep)
    state = tracks.set_tri_index(state, 0, ref_keys, ids, stored)
    state = tracks.set_tri_index(state, 1, que_keys, ids, stored)
    state = tracks.append_observations(state, torch.zeros_like(ids), ids, ref_xy, stored)
    state = tracks.append_observations(state, torch.ones_like(ids), ids, que_xy, stored)
    info = {
        "matches": valid.sum(),
        "f_inliers": F.num_inliers,
        "cheirality_counts": counts,
        "new_points": keep.sum(),
        "parallax_ok": (keep & enough_parallax).sum(),
    }
    return state, info


def _cos_parallax(X, Ca, Cb):
    ra, rb = X - Ca, X - Cb
    norms = torch.linalg.norm(ra, dim=1) * torch.linalg.norm(rb, dim=1)
    return (ra * rb).sum(1) / norms.clamp_min(1e-12)


def _bucket_ladder(n: int, floor: int, max_levels: int = 3) -> list:
    """Halving ladder [n, n/2, ...] (stops at odd sizes or the floor)."""
    ladder = [n]
    while len(ladder) < max_levels and ladder[-1] % 2 == 0 and ladder[-1] // 2 >= floor:
        ladder.append(ladder[-1] // 2)
    return ladder


def _bucket_size(count: int, ladder: list) -> int:
    """Smallest rung of the ladder that holds ``count``."""
    return ladder[sum(count <= n for n in ladder[1:])]


def _pack_indices(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the valid entries first, in original order, padded with the
    masked-out leftovers to length ``n``."""
    N = mask.shape[0]
    score = torch.where(mask, (N - torch.arange(N, device=mask.device)).to(torch.float32), 0.0)
    return stable_topk(score, n)[1]


def _localize_stage(state: SfMState, v: int, gen, config: PipelineConfig):
    """PnP against the union of all prior views' 2D-3D matches, then record
    the localised observations and triangulate new matches."""
    V, Kk = state.tri_index.shape
    targets = state.match_table[:, v, :]  # (V, K)
    valid_m = targets >= 0
    flat_pt = state.tri_index.clamp_min(0).reshape(-1).long()
    flat_tgt = targets.clamp_min(0).reshape(-1).long()
    flat_mask = (valid_m & (state.tri_index >= 0)).reshape(-1)
    X3d = state.points[flat_pt]
    uv_v_all = state.kp_xy[v][flat_tgt]
    prior_R = quat_to_rotation(state.cam_q[v - 1])
    prior_C = state.cam_C[v - 1]
    N = flat_pt.shape[0]
    ladder = _bucket_ladder(N, floor=2048) if config.localize_bucketing else [N]
    if len(ladder) > 1:
        n = _bucket_size(int(flat_mask.sum()), ladder)
        sel = _pack_indices(flat_mask, n)
        sub = estimate_pnp(gen, X3d[sel], uv_v_all[sel], state.K[v], flat_mask[sel],
                           config.pnp_ransac, config.pnp_lm, prior_R=prior_R, prior_C=prior_C)
        inliers = torch.zeros(N, dtype=torch.bool, device=sel.device)
        inliers[sel] = sub.inliers
        pnp = PnPResult(R=sub.R, C=sub.C, inliers=inliers, num_inliers=sub.num_inliers)
    else:
        pnp = estimate_pnp(gen, X3d, uv_v_all, state.K[v], flat_mask, config.pnp_ransac,
                           config.pnp_lm, prior_R=prior_R, prior_C=prior_C)
    state = tracks.set_camera(state, v, pnp.C, rotation_to_quat(pnp.R))

    # one observation per map point, from the most recent view's match
    obs_ok = flat_mask & pnp.inliers
    M = state.points.shape[0]
    order = torch.arange(N, device=obs_ok.device)
    latest = torch.full((M,), -1, dtype=torch.long, device=obs_ok.device)
    latest.scatter_reduce_(0, torch.where(obs_ok, flat_pt, M - 1),
                           torch.where(obs_ok, order, -1), "amax")
    obs_ok = obs_ok & (latest[flat_pt] == order)
    state = tracks.append_observations(state, torch.full_like(flat_pt, v), flat_pt, uv_v_all,
                                       obs_ok)
    state = tracks.set_tri_index(state, v, flat_tgt, flat_pt, obs_ok)

    P_v = camera_projection(state.K[v], pnp.R, pnp.C)
    n_before = state.num_points
    state = _triangulate_new_flat(state, v, P_v, flat_tgt, valid_m, config)
    info = {
        "matches": valid_m.sum(),
        "pnp_candidates": flat_mask.sum(),
        "pnp_inliers": pnp.num_inliers,
        "new_points": state.num_points - n_before,
    }
    return state, info


def _triangulate_new_flat(state: SfMState, v: int, P_v, flat_tgt, valid_m, config: PipelineConfig):
    """Triangulate every not-yet-constructed match (u, v, k), one candidate
    per v-key (the earliest u), gated by cheirality, reprojection error and
    parallax, and register points + observations."""
    V, Kk = state.tri_index.shape
    N = V * Kk
    dev = flat_tgt.device
    u_idx = torch.arange(V, device=dev).repeat_interleave(Kk)
    ref_keys = torch.arange(Kk, device=dev).repeat(V)
    u_free = (state.tri_index < 0).reshape(-1)
    v_free = state.tri_index[v][flat_tgt] < 0
    usable = (u_idx < v) & state.cam_valid[u_idx]
    cand = valid_m.reshape(-1) & u_free & v_free & usable
    first_u = torch.full((Kk,), V, dtype=torch.long, device=dev)
    first_u.scatter_reduce_(0, flat_tgt, torch.where(cand, u_idx, V), "amin")
    cand = cand & (first_u[flat_tgt] == u_idx)

    P_all = camera_projection(state.K, quat_to_rotation(state.cam_q), state.cam_C)
    ref_xy_full = state.kp_xy.reshape(N, 2)
    que_xy_full = state.kp_xy[v][flat_tgt]

    ladder = _bucket_ladder(N, floor=2048) if config.localize_bucketing else [N]
    n = _bucket_size(int(cand.sum()), ladder) if len(ladder) > 1 else N
    sel = _pack_indices(cand, n) if len(ladder) > 1 else torch.arange(N, device=dev)
    u_s, cand_s, tgt_s = u_idx[sel], cand[sel], flat_tgt[sel]
    P_pair = torch.stack([P_all[u_s], P_v.expand(n, 3, 4)], dim=1)
    ref_xy, que_xy = ref_xy_full[sel], que_xy_full[sel]
    uv = torch.stack([ref_xy, que_xy], dim=1)
    obs_mask = torch.stack([cand_s, cand_s], dim=1)
    Xh = triangulate(P_pair, uv, obs_mask, config.triangulation_lm)
    d_u = (P_pair[:, 0, 2, :] * Xh).sum(-1)
    d_v = (P_pair[:, 1, 2, :] * Xh).sum(-1)
    res, _ = reprojection_residuals(P_pair, Xh[:, :3], uv, obs_mask)
    small = torch.linalg.norm(res, dim=-1).amax(1) < config.triangulation_max_error_px
    enough_parallax = _cos_parallax(Xh[:, :3], state.cam_C[u_s], state.cam_C[v]) < math.cos(
        math.radians(config.min_parallax_deg))
    keep = cand_s & (d_u > 0) & (d_v > 0) & small & enough_parallax
    # every recording gates on `stored` (keep minus capacity overflow)
    state, ids, stored = tracks.allocate_points(state, Xh[:, :3], keep)
    state = tracks.set_tri_index_flat(state, u_s, ref_keys[sel], ids, stored)
    state = tracks.set_tri_index(state, v, tgt_s, ids, stored)
    state = tracks.append_observations(state, u_s, ids, ref_xy, stored)
    return tracks.append_observations(state, torch.full_like(ids, v), ids, que_xy, stored)


def _ba_ladder(M: int, O: int) -> list:
    """(points, observations) halving ladder for BA bucketing."""
    ladder = [(M, O)]
    while len(ladder) < 4:
        m, o = ladder[-1]
        if m % 2 or o % 2 or m // 2 < 256 or o // 2 < 1024:
            break
        ladder.append((m // 2, o // 2))
    return ladder


def _ba_bucket(ladder: list, n_pts: int, n_obs: int) -> tuple:
    """Smallest (points, observations) rung that holds both live counts."""
    return ladder[sum(n_pts <= m and n_obs <= o for m, o in ladder[1:])]


def _ba_stage(state: SfMState, config: PipelineConfig):
    """Bundle adjustment over all valid views/points/observations at the
    smallest prefix bucket holding the live counts (one host read), then
    pruning. Returns (state, costs, dropped_obs, pruned_obs, pruned_points)."""
    if config.ba_num_shards > 1:
        raise NotImplementedError("sharded BA is not ported")
    M, O = state.points.shape[0], state.obs_cam.shape[0]
    m, o = M, O
    if config.ba_bucketing:
        n_pts, n_obs = torch.stack([state.num_points, state.num_obs]).tolist()
        m, o = _ba_bucket(_ba_ladder(M, O), n_pts, n_obs)
    ba_state = BAState(C=state.cam_C, q=state.cam_q, X=state.points[:m],
                       cam_valid=state.cam_valid, pt_valid=state.pt_valid[:m])
    obs = BAObservations(
        cam=state.obs_cam[:o],
        point=state.obs_pt[:o],
        uv_norm=normalized_camera_coords_per_obs(state.K[state.obs_cam[:o].long()],
                                                 state.obs_uv[:o]),
        valid=state.obs_valid[:o],
    )
    out, costs = run_bundle_adjustment(ba_state, obs, config.ba)
    points = state.points.clone()
    points[:m] = out.X
    state = state._replace(cam_C=out.C, cam_q=out.q, points=points)
    zero = torch.zeros((), dtype=torch.int32, device=points.device)
    pruned_obs = pruned_pts = zero
    if config.prune_max_error_px > 0:
        state, pruned_obs, pruned_pts = tracks.prune_observations(state, config.prune_max_error_px)
    return state, costs, zero, pruned_obs, pruned_pts


def pipeline_reprojection_error(state: SfMState) -> torch.Tensor:
    """Mean pixel reprojection error over all valid observations."""
    cam, pt = state.obs_cam.long(), state.obs_pt.long()
    res, _ = pixel_residuals(state.K[cam], state.cam_C[cam], state.cam_q[cam],
                             state.points[pt], state.obs_uv)
    w = state.obs_valid.to(res.dtype)
    err = torch.linalg.norm(res * w[:, None], dim=-1)
    return err.sum() / w.sum().clamp_min(1.0)


def _zero_info(state: SfMState, config: PipelineConfig) -> dict:
    z = torch.zeros((), dtype=torch.int32, device=state.points.device)
    return {
        "matches": z,
        "f_inliers": z,
        "cheirality_counts": torch.zeros(4, dtype=torch.int32, device=z.device),
        "pnp_candidates": z,
        "pnp_inliers": z,
        "new_points": z,
        "ba_costs": torch.zeros(config.ba.iterations, dtype=state.points.dtype, device=z.device),
        "ba_dropped_obs": z,
        "pruned_obs": z,
        "pruned_points": z,
    }


def _frame_step(state: SfMState, v: int, keys: tuple, xy, desc, valid, config: PipelineConfig):
    """One frame at slot ``v``: store features, match against all prior
    views, then the v == 0 / bootstrap / localise + BA stage, and the
    reprojection metric. ``keys`` = (seed, frame) seeds the generators."""
    if any(config.distortion):
        raise NotImplementedError("lens distortion is not ported")
    dev = state.points.device
    state = tracks.set_view_features(state, v, xy, desc, valid)
    state = _match_stage(state, v, generator(dev, *keys, _STREAM_MATCH), config)
    info = _zero_info(state, config)
    if v == 0:
        dt = state.cam_C.dtype
        state = tracks.set_camera(state, 0, torch.zeros(3, dtype=dt, device=dev),
                                  torch.tensor([1.0, 0, 0, 0], dtype=dt, device=dev))
    elif v == 1:
        state, si = _bootstrap_stage(state, generator(dev, *keys, _STREAM_STAGE),
                                     generator(dev, *keys, _STREAM_STAGE_B), config)
        info.update(si)
    else:
        state, si = _localize_stage(state, v, generator(dev, *keys, _STREAM_STAGE), config)
        state, costs, dropped, pruned_o, pruned_p = _ba_stage(state, config)
        info.update(si, ba_costs=costs, ba_dropped_obs=dropped, pruned_obs=pruned_o,
                    pruned_points=pruned_p)
    info["reprojection_px"] = pipeline_reprojection_error(state)
    info["dropped_points"] = state.dropped_points
    info["dropped_obs"] = state.dropped_obs
    return state, info


def _frame_step_native(state: SfMState, v: int, keys: tuple, img, config: PipelineConfig):
    """Frame step with the frontend in front: image -> features -> frame."""
    kps, desc = detect_and_describe(img, config.frontend)
    return _frame_step(state, v, keys, kps.xy, desc, kps.mask, config)


class IncrementalSfM:
    """Host-side orchestrator; poses and the map stay on ``device``.

    ``frontend="native"`` runs the DoG frontend on the device
    (:meth:`process_image`); ``"precomputed"`` takes external features
    (:meth:`process_features`). ``device`` is required: ``"cuda"`` runs
    the hand-written kernels, ``"cpu"`` their plain versions."""

    def __init__(self, config: PipelineConfig, K, frontend: str = "native", seed: int = 0,
                 *, device):
        if config.frontend.max_keypoints != config.capacity.max_keypoints:
            raise ValueError("frontend.max_keypoints must equal capacity.max_keypoints")
        unported = {
            "keyframe gating": config.keyframe_min_flow_px > 0,
            "lens distortion": any(config.distortion),
            "sharded BA": config.ba_num_shards > 1,
        }
        missing = [name for name, on in unported.items() if on]
        if missing:
            raise NotImplementedError(f"not ported yet (ROADMAP A12/A13): {', '.join(missing)}")
        self.config = config
        self.device = torch.device(device)
        self.state = tracks.init_state(config.capacity, np.asarray(K, np.float32),
                                       desc_dim=config.frontend.descriptor_dim, device=self.device)
        self.frontend = frontend
        self.seed = seed
        self._frame = 0
        self._window = min(config.capacity.max_views, config.window_size)
        # slide mode's evicted views, oldest first, as host-numpy records
        self._archive: list = []
        self.keyframe_indices: list = []

    def _begin_frame(self, v: int, K):
        """Window policy: the slot for frame v, or None past the window in
        "stop" mode. In "slide" mode a full window evicts its oldest view
        (archived on the host) and frame v takes the last slot. A per-frame
        ``K`` is written at the slot."""
        if v < self._window:
            slot = v
        elif self.config.window_mode != "slide":
            return None
        else:
            self.state, rec = tracks.evict_oldest_view(self.state)
            self._archive.append(tracks.EvictionRecord(*(a.cpu().numpy() for a in rec)))
            slot = self._window - 1
        if K is not None:
            K = torch.as_tensor(np.asarray(K, np.float32))
            self.state = tracks.set_view_K(self.state, slot, K)
        return slot

    def process_image(self, img, K=None) -> dict:
        """One frame from a raw (H, W) image; ``K`` optional per-frame
        intrinsics."""
        if self.frontend != "native":
            raise RuntimeError("process_image requires the native frontend")
        v = self._frame
        slot = self._begin_frame(v, K)
        if slot is None:
            return {"skipped": True, "frame": v}
        img = torch.as_tensor(np.asarray(img)).to(self.device)
        self.state, info = _frame_step_native(self.state, slot, (self.seed, v), img, self.config)
        return self._finish_frame(v, info)

    def process_features(self, xy, desc, valid, K=None) -> dict:
        v = self._frame
        slot = self._begin_frame(v, K)
        if slot is None:
            return {"skipped": True, "frame": v}
        t = lambda a, dt: torch.as_tensor(np.asarray(a)).to(self.device, dt)  # noqa: E731
        self.state, info = _frame_step(
            self.state, slot, (self.seed, v), t(xy, torch.float32), t(desc, torch.float32),
            t(valid, torch.bool), self.config,
        )
        return self._finish_frame(v, info)

    def _finish_frame(self, v: int, info: dict) -> dict:
        self._frame = v + 1
        self.keyframe_indices.append(v)
        info = {k: (val.cpu().numpy() if torch.is_tensor(val) else val)
                for k, val in dict(info, frame=v).items()}
        info["reprojection_px"] = float(info["reprojection_px"])
        return info

    # -- checkpointing -------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Persist the whole engine: state, frame counter, eviction archive
        and keyframe bookkeeping (the JAX package's npz layout)."""
        from structure_from_motion_tpu_torch.utils import checkpoint

        checkpoint.save_state(path, self.state, self._frame, archive=self._archive,
                              keyframes=(self.keyframe_indices, self._frame))

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint of either package; returns the resume frame."""
        from structure_from_motion_tpu_torch.utils import checkpoint

        self.state, self._frame, self._archive, kf = checkpoint.load_state(path, self.device)
        self.keyframe_indices = kf[0]
        return self._frame

    # -- results -------------------------------------------------------------
    def finalize(self, iterations: int = 10):
        """Bundle adjustment of the live window with ``iterations`` LM
        iterations (the per-frame BA runs ``config.ba.iterations``).
        Returns the per-iteration costs."""
        cfg = dataclasses.replace(self.config,
                                  ba=dataclasses.replace(self.config.ba, iterations=iterations))
        self.state, costs, _, _, _ = _ba_stage(self.state, cfg)
        return costs.cpu().numpy()

    def finalize_global(self, iterations: int = 20, num_shards: int = 1,
                        min_obs: int = 2) -> dict:
        """Bundle adjustment over every camera of the run: the eviction
        archive plus the live window, reassembled by global point id
        (``models/global_ba.py``). Writes the refined archived poses, live
        poses and live map back. Returns the problem size, the
        per-iteration costs, the tiers, the slot count and the PCG
        iterations of each LM iteration (empty for a dense solve)."""
        n_live = min(self._frame, self._window)
        prob = global_ba.build_global_problem(self.state, self._archive, n_live, min_obs=min_obs)
        stats: dict = {}
        out, costs = global_ba.solve_global(prob, self.config.ba, iterations=iterations,
                                            num_shards=num_shards, stats=stats)
        A = len(self._archive)
        C, q = out.C.cpu().numpy(), out.q.cpu().numpy()
        self._archive = [r._replace(C=C[i], q=q[i]) for i, r in enumerate(self._archive)]
        cam_C, cam_q = self.state.cam_C.clone(), self.state.cam_q.clone()
        cam_C[:n_live] = out.C[A:A + n_live]
        cam_q[:n_live] = out.q[A:A + n_live]
        # refined points back into their live map slots (dead points have
        # none; their refinement lives only in the solved problem)
        sel = prob.gids[:prob.n_points]
        live_gid = self.state.pt_gid.cpu().numpy()
        j = np.clip(np.searchsorted(sel, np.clip(live_gid, 0, None)), 0,
                    max(prob.n_points - 1, 0))
        ok = self.state.pt_valid.cpu().numpy() & (live_gid >= 0)
        ok = ok & (sel[j] == live_gid) if prob.n_points else np.zeros_like(ok)
        points = self.state.points.clone()
        dev = points.device
        rows = torch.as_tensor(np.nonzero(ok)[0]).to(dev)
        points[rows] = out.X[torch.as_tensor(j[ok]).to(dev)]
        self.state = self.state._replace(cam_C=cam_C, cam_q=cam_q, points=points)
        return dict(stats, costs=costs, n_cams=prob.n_cams, n_points=prob.n_points,
                    n_obs=prob.n_obs, max_track_len=prob.max_track_len)

    def reprojection_error(self) -> float:
        """Mean pixel reprojection error over all observations."""
        return float(pipeline_reprojection_error(self.state))

    def poses(self):
        """(locs (F, 3), rots (F, 3, 3)) numpy, cam-to-world, for every
        processed frame: the archived (evicted) views, then the live
        window."""
        n = min(self._frame, self._window)
        C = self.state.cam_C[:n].cpu().numpy()
        R = quat_to_rotation(self.state.cam_q[:n]).cpu().numpy()
        if self._archive:
            Ca = np.stack([np.asarray(r.C) for r in self._archive])
            qa = torch.as_tensor(np.stack([np.asarray(r.q) for r in self._archive]))
            C = np.concatenate([Ca, C])
            R = np.concatenate([quat_to_rotation(qa).numpy(), R])
        return C, R

    def map_points(self):
        return self.state.points[self.state.pt_valid].cpu().numpy()
