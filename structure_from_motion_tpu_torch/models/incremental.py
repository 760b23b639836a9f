"""The flagship model: incremental Structure-from-Motion (port of
``structure_from_motion_tpu/models/incremental.py``).

Same stages over the same fixed-capacity :class:`SfMState`: frame 0 pins
view 0 at the origin, frame 1 bootstraps from two views (two F draws, the
one with more parallax-clearing points wins), later frames localise by PnP
against the union of all prior views' 2D-3D matches, triangulate every new
match, run bundle adjustment and prune.

The stages are written once, for a lane stack of states (every field with a
leading lane axis): :class:`IncrementalSfM` runs them on a stack of one
lane, ``models/batched.py`` on B sequences in lockstep (the JAX package
``vmap``s one copy). For the whole stack:

* every kernel launches ONCE a stage: B3 on each lane's prior views
  against its own new view, B4 on every lane's BA observations;
* the JAX package fuses a frame into one jitted program and picks buckets
  on device with ``lax.switch``; here the code runs eagerly, so each
  bucketed stage makes ONE host read of the LARGEST live count across lanes
  and every lane runs at the smallest power-of-two bucket that holds it
  (the same ladders, so the set of shapes stays small; a lane below it
  just pads, as a lane of the JAX package does);
* the LM loops of PnP and triangulation stop lane by lane: a finished lane
  takes no step and keeps its iterate, and the loop ends when no lane
  moves (the vmapped ``while_loop``);
* the ``lax.map`` over prior views in the match stage is one batched call
  with a leading view axis; the small pure pieces of the bootstrap (pose
  from E, cheirality, the essential-manifold refinement) go through
  ``torch.func.vmap``.

Random draws come from ``torch.Generator``s seeded from ``(seed, frame,
stream)``, one generator a lane and draw (the one per-lane loop left: a
generator's stream cannot be split), so a lane draws what a single run with
its seed draws; a shared bucket larger than a lane's own changes the shape
of its PnP and triangulation draws, so lanes agree with single runs to a
tolerance, as in the JAX package.

``window_mode="slide"`` evicts the oldest view once the window is full and
keeps its record on the host; :meth:`IncrementalSfM.finalize_global` solves
the whole trajectory from that archive plus the live window
(``models/global_ba.py``), and checkpoints use the JAX package's npz
layout. With ``config.keyframe_min_flow_px`` set, a frame whose median match
displacement against the last accepted frame is too small is skipped before
it is admitted; with ``config.distortion`` set, keypoints are undistorted
once at ingest. With ``config.ba_num_shards`` = S > 1 the per-frame BA is
sharded over S ranks (``parallel/``): every rank runs the whole engine on
the same frames with the same seeds, and only the bundle adjustment
splits its points and observations between them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.func import vmap

from structure_from_motion_tpu_torch.config import PipelineConfig
from structure_from_motion_tpu_torch.device import generator, stable_topk
from structure_from_motion_tpu_torch.models import global_ba, tracks
from structure_from_motion_tpu_torch.models.tracks import SfMState, _lane, lanewise
from structure_from_motion_tpu_torch.ops.ba import BAObservations, BAState, run_bundle_adjustment
from structure_from_motion_tpu_torch.ops.distortion import undistort_pixels
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
from structure_from_motion_tpu_torch.parallel import (
    interleaved_bundle_adjustment,
    make_mesh,
    replicate_first_rank,
)
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


def _gens(st: SfMState, seeds, frame: int, stream: int) -> list:
    """One generator a lane: lane b's is the one a single run with seed
    ``seeds[b]`` draws from at this frame and stream."""
    return [generator(st.points.device, int(s), frame, stream) for s in seeds]


def _match_stage(st: SfMState, v: int, gens, config: PipelineConfig) -> SfMState:
    """Every lane's view v against its prior views: ONE B3 launch for all
    lanes and views, then the per-view F-gate RANSAC with a (lane, view)
    batch, only for views with enough matches, and the matches recorded."""
    B, V = st.kp_desc.shape[:2]
    prior = torch.arange(V, device=st.kp_desc.device) < v
    res = match_descriptors(st.kp_desc, st.kp_desc[:, v], st.kp_valid & prior[:, None],
                            st.kp_valid[:, v], config.matcher)
    valid = res.valid
    if config.matcher.use_fundamental_gate:
        rc = config.matcher.gate_ransac
        ar = torch.arange(B, device=valid.device)[:, None, None]
        que_xy = st.kp_xy[:, v][ar, res.target.clamp_min(0).long()]  # (B, V, K, 2)
        idx_sets = sample_index_sets(gens, valid, rc.num_hypotheses, 8)
        gate = find_fundamental(idx_sets, st.kp_xy, que_xy, valid, rc)
        # only gate views with enough matches for a meaningful model
        enough = valid.sum(-1, keepdim=True) >= 16
        valid = torch.where(enough, valid & gate.inliers, valid)
    return tracks.record_matches(st, v, res.target, valid & prior[:, None])


def _cos_parallax(X, Ca, Cb):
    ra, rb = X - Ca, X - Cb
    norms = torch.linalg.norm(ra, dim=-1) * torch.linalg.norm(rb, dim=-1)
    return (ra * rb).sum(-1) / norms.clamp_min(1e-12)


def _two_view_geometry(F, inliers, K0, K1, q0, C0, ref_xy, que_xy, valid):
    """One lane's pose from F (vmapped): the four (R, C) candidates,
    cheirality, and the essential-manifold refinement of the winner."""
    cands = decompose_essential(essential_from_fundamental(F, K0, K1))
    P_ref = camera_projection(K0, quat_to_rotation(q0), C0)
    P_cands = candidate_projections(K1, cands)
    uv = torch.stack([ref_xy, que_xy], dim=1)
    obs_mask = torch.stack([valid, valid], dim=1)
    X4 = torch.stack([linear_triangulate(torch.stack([P_ref, P_cands[i]]), uv, obs_mask)
                      for i in range(4)])
    best, counts, cheir_ok = disambiguate_poses(P_ref, P_cands, X4, valid)
    R1, _, C1 = refine_relative_pose(
        cands.R[best], cands.t[best], normalized_camera_coords(K0, ref_xy),
        normalized_camera_coords(K1, que_xy), valid & inliers,
    )
    P_pair = torch.stack([P_ref, camera_projection(K1, R1, C1)])
    return R1, C1, P_pair, linear_triangulate(P_pair, uv, obs_mask), counts, cheir_ok


def _bootstrap_once(st: SfMState, gens, config: PipelineConfig):
    B, _, Kk = st.tri_index.shape
    ref_keys, que_keys, ref_xy, que_xy, valid = tracks.matched_pair_arrays(st, 0, 1)
    rc = config.fundamental_ransac
    F = find_fundamental(sample_index_sets(gens, valid, rc.num_hypotheses, 8),
                         ref_xy, que_xy, valid, rc)
    R1, C1, P_pair, X2, counts, cheir_ok = vmap(_two_view_geometry)(
        F.F, F.inliers, st.K[:, 0], st.K[:, 1], st.cam_q[:, 0], st.cam_C[:, 0], ref_xy, que_xy,
        valid)
    st = tracks.set_camera(st, 1, C1, rotation_to_quat(R1))
    P = P_pair[:, None].expand(B, Kk, 2, 3, 4).reshape(B * Kk, 2, 3, 4)
    uv = torch.stack([ref_xy, que_xy], dim=2).reshape(B * Kk, 2, 2)
    obs_mask = torch.stack([valid, valid], dim=2).reshape(B * Kk, 2)
    cm = torch.stack([cheir_ok, cheir_ok], dim=2).reshape(B * Kk, 2)
    Xh = refine_triangulate(P, uv, cm, X2.reshape(B * Kk, 4), config.triangulation_lm, lanes=B)

    # admission: cheirality AND epipolar inlier AND two-view reprojection;
    # parallax only feeds the draw-selection metric
    res, _ = reprojection_residuals(P, Xh[:, :3], uv, obs_mask)
    small = torch.linalg.norm(res, dim=-1).amax(1) < config.triangulation_max_error_px
    X3 = Xh[:, :3].reshape(B, Kk, 3)
    enough_parallax = _cos_parallax(X3, st.cam_C[:, 0][:, None], C1[:, None]) < math.cos(
        math.radians(config.min_parallax_deg))
    keep = cheir_ok & F.inliers & small.reshape(B, Kk)
    st, ids, stored = tracks.allocate_points(st, X3, keep)
    st = tracks.set_tri_index(st, 0, ref_keys, ids, stored)
    st = tracks.set_tri_index(st, 1, que_keys, ids, stored)
    st = tracks.append_observations(st, torch.zeros_like(ids), ids, ref_xy, stored)
    st = tracks.append_observations(st, torch.ones_like(ids), ids, que_xy, stored)
    info = {
        "matches": valid.sum(1),
        "f_inliers": F.num_inliers,
        "cheirality_counts": counts,
        "new_points": keep.sum(1),
        "parallax_ok": (keep & enough_parallax).sum(1),
    }
    return st, info


def _pick(take_b: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(take_b.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)


def _bootstrap_stage(st: SfMState, gens_a, gens_b, config: PipelineConfig):
    """Two-view bootstrap with two independent F draws a lane; each lane
    keeps the draw with more admitted points that also clear the parallax
    threshold (no host read)."""
    st_a, info_a = _bootstrap_once(st, gens_a, config)
    st_b, info_b = _bootstrap_once(st, gens_b, config)
    take_b = info_b["parallax_ok"] > info_a["parallax_ok"]
    st = SfMState(*(_pick(take_b, a, b) for a, b in zip(st_a, st_b)))
    info = {k: _pick(take_b, info_a[k], info_b[k]) for k in info_a if k != "parallax_ok"}
    return st, info


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
    masked-out leftovers to length ``n`` (each lane its own)."""
    N = mask.shape[-1]
    score = torch.where(mask, (N - torch.arange(N, device=mask.device)).to(torch.float32), 0.0)
    return stable_topk(score, n)[1]


def _localize_stage(st: SfMState, v: int, gens, config: PipelineConfig):
    """PnP of every lane's view v against the union of its prior views'
    2D-3D matches at ONE shared bucket (one host read), then the localised
    observations and the triangulation of new matches."""
    B, V, Kk = st.tri_index.shape
    dev = st.points.device
    ar = _lane(B, dev)
    targets = st.match_table[:, :, v, :]  # (B, V, K)
    valid_m = targets >= 0
    flat_pt = st.tri_index.clamp_min(0).reshape(B, -1).long()
    flat_tgt = targets.clamp_min(0).reshape(B, -1).long()
    flat_mask = (valid_m & (st.tri_index >= 0)).reshape(B, -1)
    X3d = st.points[ar, flat_pt]
    uv_v_all = st.kp_xy[:, v][ar, flat_tgt]
    prior_R = quat_to_rotation(st.cam_q[:, v - 1])
    prior_C = st.cam_C[:, v - 1]
    N = V * Kk
    K_v = st.K[:, v]
    ladder = _bucket_ladder(N, floor=2048) if config.localize_bucketing else [N]
    if len(ladder) > 1:
        n = _bucket_size(int(flat_mask.sum(1).max()), ladder)
        sel = _pack_indices(flat_mask, n)
        sub = estimate_pnp(gens, X3d[ar, sel], uv_v_all[ar, sel], K_v, flat_mask[ar, sel],
                           config.pnp_ransac, config.pnp_lm, prior_R=prior_R, prior_C=prior_C)
        inliers = torch.zeros((B, N), dtype=torch.bool, device=dev)
        inliers[ar, sel] = sub.inliers
        pnp = PnPResult(R=sub.R, C=sub.C, inliers=inliers, num_inliers=sub.num_inliers)
    else:
        pnp = estimate_pnp(gens, X3d, uv_v_all, K_v, flat_mask, config.pnp_ransac,
                           config.pnp_lm, prior_R=prior_R, prior_C=prior_C)
    st = tracks.set_camera(st, v, pnp.C, rotation_to_quat(pnp.R))

    # one observation per map point, from the most recent view's match
    obs_ok = flat_mask & pnp.inliers
    M = st.points.shape[1]
    order = torch.arange(N, device=dev).expand(B, N)
    latest = torch.full((B * M,), -1, dtype=torch.long, device=dev)
    latest.scatter_reduce_(0, (torch.where(obs_ok, flat_pt, M - 1) + ar * M).reshape(-1),
                           torch.where(obs_ok, order, -1).reshape(-1), "amax")
    obs_ok = obs_ok & (latest.view(B, M)[ar, flat_pt] == order)
    st = tracks.append_observations(st, torch.full_like(flat_pt, v), flat_pt, uv_v_all, obs_ok)
    st = tracks.set_tri_index(st, v, flat_tgt, flat_pt, obs_ok)

    P_v = camera_projection(K_v, pnp.R, pnp.C)
    n_before = st.num_points
    st = _triangulate_new_flat(st, v, P_v, flat_tgt, valid_m, config)
    info = {
        "matches": valid_m.sum((1, 2)),
        "pnp_candidates": flat_mask.sum(1),
        "pnp_inliers": pnp.num_inliers,
        "new_points": st.num_points - n_before,
    }
    return st, info


def _triangulate_new_flat(st: SfMState, v: int, P_v, flat_tgt, valid_m, config: PipelineConfig):
    """Triangulate every not-yet-constructed match (u, v, k) of every lane,
    one candidate per v-key (the earliest u), at ONE shared bucket, gated by
    cheirality, reprojection error and parallax, and register points and
    observations."""
    B, V, Kk = st.tri_index.shape
    N = V * Kk
    dev = flat_tgt.device
    ar = _lane(B, dev)
    u_idx = torch.arange(V, device=dev).repeat_interleave(Kk)
    ref_keys = torch.arange(Kk, device=dev).repeat(V)
    u_free = (st.tri_index < 0).reshape(B, -1)
    v_free = st.tri_index[:, v][ar, flat_tgt] < 0
    usable = (u_idx < v) & st.cam_valid[:, u_idx]
    cand = valid_m.reshape(B, -1) & u_free & v_free & usable
    first_u = torch.full((B * Kk,), V, dtype=torch.long, device=dev)
    first_u.scatter_reduce_(0, (flat_tgt + ar * Kk).reshape(-1),
                            torch.where(cand, u_idx, V).reshape(-1), "amin")
    cand = cand & (first_u.view(B, Kk)[ar, flat_tgt] == u_idx)

    P_all = camera_projection(st.K, quat_to_rotation(st.cam_q), st.cam_C)  # (B, V, 3, 4)
    ref_xy_full = st.kp_xy.reshape(B, N, 2)
    que_xy_full = st.kp_xy[:, v][ar, flat_tgt]

    ladder = _bucket_ladder(N, floor=2048) if config.localize_bucketing else [N]
    if len(ladder) > 1:
        n = _bucket_size(int(cand.sum(1).max()), ladder)
        sel = _pack_indices(cand, n)
    else:
        n, sel = N, torch.arange(N, device=dev).expand(B, N)
    u_s, cand_s, tgt_s = u_idx[sel], cand[ar, sel], flat_tgt[ar, sel]
    P_pair = torch.stack([P_all[ar, u_s], P_v[:, None].expand(B, n, 3, 4)], dim=2)
    ref_xy, que_xy = ref_xy_full[ar, sel], que_xy_full[ar, sel]
    P = P_pair.reshape(B * n, 2, 3, 4)
    uv = torch.stack([ref_xy, que_xy], dim=2).reshape(B * n, 2, 2)
    obs_mask = torch.stack([cand_s, cand_s], dim=2).reshape(B * n, 2)
    Xh = triangulate(P, uv, obs_mask, config.triangulation_lm, lanes=B)
    d_u = (P[:, 0, 2, :] * Xh).sum(-1).reshape(B, n)
    d_v = (P[:, 1, 2, :] * Xh).sum(-1).reshape(B, n)
    res, _ = reprojection_residuals(P, Xh[:, :3], uv, obs_mask)
    small = (torch.linalg.norm(res, dim=-1).amax(1) < config.triangulation_max_error_px)
    X3 = Xh[:, :3].reshape(B, n, 3)
    enough_parallax = _cos_parallax(X3, st.cam_C[ar, u_s], st.cam_C[:, v][:, None]) < math.cos(
        math.radians(config.min_parallax_deg))
    keep = cand_s & (d_u > 0) & (d_v > 0) & small.reshape(B, n) & enough_parallax
    # every recording gates on `stored` (keep minus capacity overflow)
    st, ids, stored = tracks.allocate_points(st, X3, keep)
    st = tracks.set_tri_index_flat(st, u_s, ref_keys[sel], ids, stored)
    st = tracks.set_tri_index(st, v, tgt_s, ids, stored)
    st = tracks.append_observations(st, u_s, ids, ref_xy, stored)
    return tracks.append_observations(st, torch.full_like(ids, v), ids, que_xy, stored)


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


def _sharded_ba(st: SfMState, config: PipelineConfig):
    """The per-frame BA of one lane sharded over ``config.ba_num_shards``
    ranks, on rank 0's state: full capacity (no bucket ladder), points
    round-robin, ``O // S`` observation slots a shard. Returns (that state
    with its cameras and map refined, costs, observations dropped by a
    full bucket)."""
    if st.points.shape[0] != 1:
        raise ValueError("a lane stack of sequences is not sharded")
    S = config.ba_num_shards
    mesh = make_mesh(S)
    # every rank takes rank 0's state (the ranks' engines need not agree to
    # the bit), so the ranks solve one problem and leave with one state
    st = SfMState(*(replicate_first_rank(t, mesh) for t in st))
    one = tracks.lane_state(st, 0)
    obs = BAObservations(cam=one.obs_cam, point=one.obs_pt,
                         uv_norm=normalized_camera_coords_per_obs(one.K[one.obs_cam.long()],
                                                                  one.obs_uv),
                         valid=one.obs_valid)
    ba_state = BAState(C=one.cam_C, q=one.cam_q, X=one.points, cam_valid=one.cam_valid,
                       pt_valid=one.pt_valid)
    out, costs, dropped = interleaved_bundle_adjustment(ba_state, obs, config.ba, mesh,
                                                        one.obs_cam.shape[0] // S)
    st = st._replace(cam_C=out.C[None], cam_q=out.q[None], points=out.X[None])
    return st, costs[None], dropped.to(torch.int32)[None]


@lanewise
def _ba_stage(st: SfMState, config: PipelineConfig):
    """Bundle adjustment of every lane over all its valid views, points and
    observations at ONE shared prefix bucket holding the largest live counts
    (one host read; one B4 launch an LM iteration for all lanes), or sharded
    over ``config.ba_num_shards`` ranks (one lane), then pruning. Returns
    (state, costs, dropped_obs, pruned_obs, pruned_points)."""
    if config.ba_num_shards > 1:
        return _prune(config, *_sharded_ba(st, config))
    B, M = st.points.shape[:2]
    O = st.obs_cam.shape[1]
    m, o = M, O
    if config.ba_bucketing:
        n_pts, n_obs = torch.stack([st.num_points.max(), st.num_obs.max()]).tolist()
        m, o = _ba_bucket(_ba_ladder(M, O), n_pts, n_obs)
    cam_o = st.obs_cam[:, :o]
    ba_state = BAState(C=st.cam_C, q=st.cam_q, X=st.points[:, :m], cam_valid=st.cam_valid,
                       pt_valid=st.pt_valid[:, :m])
    obs = BAObservations(
        cam=cam_o,
        point=st.obs_pt[:, :o],
        uv_norm=normalized_camera_coords_per_obs(st.K[_lane(B, st.K.device), cam_o.long()],
                                                 st.obs_uv[:, :o]),
        valid=st.obs_valid[:, :o],
    )
    out, costs = run_bundle_adjustment(ba_state, obs, config.ba)
    points = st.points.clone()
    points[:, :m] = out.X
    st = st._replace(cam_C=out.C, cam_q=out.q, points=points)
    return _prune(config, st, costs, torch.zeros(B, dtype=torch.int32, device=points.device))


def _prune(config: PipelineConfig, st: SfMState, costs, dropped):
    """The pruning after a BA -> :func:`_ba_stage`'s five results."""
    pruned_obs = pruned_pts = torch.zeros_like(dropped)
    if config.prune_max_error_px > 0:
        st, pruned_obs, pruned_pts = tracks.prune_observations(st, config.prune_max_error_px)
    return st, costs, dropped, pruned_obs, pruned_pts


def _zero_info(st: SfMState, config: PipelineConfig) -> dict:
    B = st.points.shape[0]
    z = torch.zeros(B, dtype=torch.int32, device=st.points.device)
    return {
        "matches": z,
        "f_inliers": z,
        "cheirality_counts": torch.zeros((B, 4), dtype=torch.int32, device=z.device),
        "pnp_candidates": z,
        "pnp_inliers": z,
        "new_points": z,
        "ba_costs": torch.zeros((B, config.ba.iterations), dtype=st.points.dtype,
                                device=z.device),
        "ba_dropped_obs": z,
        "pruned_obs": z,
        "pruned_points": z,
    }


def _frame_step(st: SfMState, v: int, seeds, frame: int, xy, desc, valid,
                config: PipelineConfig):
    """One frame at slot ``v`` for every lane: store features, match
    against all prior views, then the v == 0 / bootstrap / localise + BA
    stage, and the reprojection metric. ``xy``, ``desc``, ``valid`` carry
    the lane axis; lane b's generators come from ``(seeds[b], frame)``."""
    if any(config.distortion):
        # known lens distortion: undistort the measurements ONCE at ingest,
        # so that every later residual is the pinhole residual
        xy = vmap(lambda x, K: undistort_pixels(x, K, config.distortion))(xy, st.K[:, v])
    dev = st.points.device
    B = st.points.shape[0]
    st = tracks.set_view_features(st, v, xy, desc, valid)
    st = _match_stage(st, v, _gens(st, seeds, frame, _STREAM_MATCH), config)
    info = _zero_info(st, config)
    if v == 0:
        dt = st.cam_C.dtype
        st = tracks.set_camera(st, 0, torch.zeros((B, 3), dtype=dt, device=dev),
                               torch.tensor([1.0, 0, 0, 0], dtype=dt, device=dev).expand(B, 4))
    elif v == 1:
        st, si = _bootstrap_stage(st, _gens(st, seeds, frame, _STREAM_STAGE),
                                  _gens(st, seeds, frame, _STREAM_STAGE_B), config)
        info.update(si)
    else:
        st, si = _localize_stage(st, v, _gens(st, seeds, frame, _STREAM_STAGE), config)
        st, costs, dropped, pruned_o, pruned_p = _ba_stage(st, config)
        info.update(si, ba_costs=costs, ba_dropped_obs=dropped, pruned_obs=pruned_o,
                    pruned_points=pruned_p)
    info["reprojection_px"] = tracks.reprojection_error(st)
    info["dropped_points"] = st.dropped_points
    info["dropped_obs"] = st.dropped_obs
    return st, info


def _single_step(state: SfMState, v: int, seed: int, frame: int, xy, desc, valid,
                 config: PipelineConfig):
    """:func:`_frame_step` on one state: a stack of one lane."""
    st, info = _frame_step(tracks.lanes_of(state), v, [seed], frame, xy[None], desc[None],
                           valid[None], config)
    return tracks.lane_state(st, 0), {k: t[0] for k, t in info.items()}


def _assess_frame(state: SfMState, prev_slot: int, xy, desc, valid,
                  config: PipelineConfig) -> torch.Tensor:
    """Keyframe statistic: median pixel displacement of the candidate
    frame's descriptor matches against the stored view ``prev_slot`` (the
    last ACCEPTED frame), without the fundamental gate: raw ratio matches
    are a fine flow estimate before the frame is admitted.

    Returns +inf (so the frame is admitted) when fewer than 8 matches exist:
    a scene cut carries new content even with no matched flow."""
    mcfg = dataclasses.replace(config.matcher, use_fundamental_gate=False)
    res = match_descriptors(state.kp_desc[prev_slot], desc, state.kp_valid[prev_slot], valid,
                            mcfg)
    if any(config.distortion):
        # the STORED keypoints were undistorted at ingest; raw candidate
        # coordinates against them would measure the distortion, not motion.
        # prev_slot's K stands in for the candidate's (a flow statistic)
        xy = undistort_pixels(xy, state.K[prev_slot], config.distortion)
    disp = torch.linalg.norm(xy[res.target.clamp_min(0).long()] - state.kp_xy[prev_slot], dim=-1)
    n = res.valid.sum()
    med = _nanmedian_mid(torch.where(res.valid, disp, torch.full_like(disp, math.nan)), n)
    return torch.where(n >= 8, med, torch.full_like(med, math.inf))


def _nanmedian_mid(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Median of the ``n`` non-NaN entries of ``x`` as numpy's ``nanmedian``
    takes it: the mean of the two middle values when ``n`` is even
    (``torch.nanmedian`` returns the lower one). NaN when ``n`` is 0."""
    srt = torch.sort(x).values  # NaNs last
    lo = ((n - 1) // 2).clamp_min(0)
    hi = (n // 2).clamp(0, x.numel() - 1)
    return 0.5 * (srt[lo] + srt[hi])


def _frame_step_native(state: SfMState, v: int, seed: int, frame: int, img,
                       config: PipelineConfig):
    """Frame step with the frontend in front: image -> features -> frame."""
    kps, desc = detect_and_describe(img, config.frontend)
    return _single_step(state, v, seed, frame, kps.xy, desc, kps.mask, config)


class IncrementalSfM:
    """Host-side orchestrator; poses and the map stay on ``device``.

    ``frontend="native"`` runs the DoG frontend on the device
    (:meth:`process_image`); ``"precomputed"`` takes external features
    (:meth:`process_features`). ``device`` defaults to ``"cuda"``, which
    runs the hand-written kernels and raises on a machine without a card;
    ``"cpu"`` runs their plain versions, as the tests do."""

    def __init__(self, config: PipelineConfig, K, frontend: str = "native", seed: int = 0,
                 *, device="cuda"):
        if config.frontend.max_keypoints != config.capacity.max_keypoints:
            raise ValueError("frontend.max_keypoints must equal capacity.max_keypoints")
        if config.ba_num_shards > 1:
            S = config.ba_num_shards
            if config.capacity.max_points % S or config.capacity.max_observations % S:
                raise ValueError("capacity.max_points and max_observations must be divisible "
                                 f"by ba_num_shards={S}")
            make_mesh(S)  # raises, naming torchrun, without a group of S ranks
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
        # keyframe bookkeeping: the input index of every ACCEPTED frame (the
        # identity when keyframe_min_flow_px == 0) and the next input's index
        self._input_index = 0
        self.keyframe_indices: list = []

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        """A tensor on the engine's device as it is, a CPU tensor or an array
        by upload; a tensor of another device is refused."""
        if torch.is_tensor(a):
            if a.device.type != "cpu" and a.device != self.state.points.device:
                raise ValueError(f"input on {a.device}, the engine runs on {self.device}")
        else:
            a = torch.as_tensor(np.asarray(a))
        return a.to(self.device, dtype) if dtype is not None else a.to(self.device)

    def _keyframe_flow(self, assess):
        """Run the keyframe gate: the flow statistic (one host read), or None
        when gating is off or no previous view exists. ``assess`` takes the
        slot of the last accepted frame."""
        if self.config.keyframe_min_flow_px <= 0 or self._frame < 1:
            return None
        return float(assess(min(self._frame, self._window) - 1))

    def _skip_info(self, flow: float) -> dict:
        info = {"keyframe_skipped": True, "flow_px": flow, "frame": self._frame,
                "input_index": self._input_index}
        self._input_index += 1
        return info

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

    def detect(self, img):
        """The frontend alone: (H, W) image (array, CPU tensor or tensor on
        the engine's device) -> ``(Keypoints, descriptors)`` on the device."""
        return detect_and_describe(self._to_device(img), self.config.frontend)

    def process_image(self, img, K=None) -> dict:
        """One frame from a raw (H, W) image (an array, a CPU tensor, or a
        tensor already on the engine's device, as a prefetcher hands over);
        ``K`` optional per-frame intrinsics. With the keyframe gate on, a
        low-parallax frame is rejected after detection and one host read; an
        admitted frame reuses the detected features."""
        if self.frontend != "native":
            raise RuntimeError("process_image requires the native frontend")
        img = self._to_device(img)
        if self.config.keyframe_min_flow_px > 0 and self._frame >= 1:
            kps, desc = detect_and_describe(img, self.config.frontend)
            return self._gated(kps.xy, desc, kps.mask, K)
        v = self._frame
        slot = self._begin_frame(v, K)
        if slot is None:
            return {"skipped": True, "frame": v}
        self.state, info = _frame_step_native(self.state, slot, self.seed, v, img, self.config)
        return self._finish_frame(v, info)

    def process_features(self, xy, desc, valid, K=None) -> dict:
        return self._gated(self._to_device(xy, torch.float32), self._to_device(desc, torch.float32),
                           self._to_device(valid, torch.bool), K)

    def _gated(self, xy, desc, valid, K) -> dict:
        """The keyframe gate, then the frame step, on device features."""
        flow = self._keyframe_flow(
            lambda prev: _assess_frame(self.state, prev, xy, desc, valid, self.config))
        if flow is not None and flow < self.config.keyframe_min_flow_px:
            return self._skip_info(flow)
        v = self._frame
        slot = self._begin_frame(v, K)
        if slot is None:
            return {"skipped": True, "frame": v}
        self.state, info = _single_step(self.state, slot, self.seed, v, xy, desc, valid,
                                        self.config)
        info = self._finish_frame(v, info)
        if flow is not None:
            info["flow_px"] = flow
        return info

    def _finish_frame(self, v: int, info: dict) -> dict:
        self._frame = v + 1
        self.keyframe_indices.append(self._input_index)
        self._input_index += 1
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
                              keyframes=(self.keyframe_indices, self._input_index))

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint of either package; returns the resume frame."""
        from structure_from_motion_tpu_torch.utils import checkpoint

        self.state, self._frame, self._archive, kf = checkpoint.load_state(path, self.device)
        self.keyframe_indices, self._input_index = kf
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
        return float(tracks.reprojection_error(self.state))

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
