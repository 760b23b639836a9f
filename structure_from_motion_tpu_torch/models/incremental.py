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
* the JAX package fuses a frame into one jitted program and picks the
  stage and the buckets on device with ``lax.switch``; here a steady frame
  is ONE ``utils/control.graphed`` call (one CUDA graph replay on the
  card, :func:`_frame_step`), and each choice is a
  ``utils/control.switch`` on the LARGEST live count across lanes: an IF
  node a rung in the graph, decided on the device (eagerly one host read;
  the stage, a Python int, costs none), every lane at the smallest
  power-of-two bucket that holds it (the same ladders, so the set of
  shapes stays small; a lane below it just pads, as a lane of the JAX
  package does); in an exported program (``serve.py``) a ``cond`` node;
* the LM loops of PnP and triangulation stop lane by lane
  (``utils/control.masked_loop``): a finished lane takes no step and keeps
  its iterate, and the loop ends when no lane moves (the vmapped
  ``while_loop``): in the graph a WHILE node stopped on the device,
  eagerly read once every chunk of steps; the fixed-count loops (BA
  iterations, LO rounds, the essential-manifold refinement) are
  ``utils/control.fori``;
* the ``lax.map`` over prior views in the match stage is one batched call
  with a leading view axis; the small pure pieces of the bootstrap (pose
  from E, cheirality, the essential-manifold refinement step) go through
  ``utils/control.lane_map`` (``torch.func.vmap`` for several lanes; one
  lane runs them on itself, which an exported program can hold).

The draws are :class:`LazyDraws` in the live engine: made when a stage
asks, from fresh ``torch.Generator``s seeded from ``(seed, frame,
stream)``, one a lane and draw (the one per-lane loop left: a generator's
stream cannot be split), so a lane draws what a single run with its seed
draws, and a PnP rung draws the same whichever rung is taken. A steady
frame draws every rung's before its graph replay (a graph would replay one
draw forever), and a served engine passes every draw a frame may use
(:class:`FrameDraws`) into the exported program. A shared bucket larger than a lane's own changes
the shape of its PnP and triangulation draws, so lanes agree with single
runs to a tolerance, as in the JAX package.

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
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from structure_from_motion_tpu_torch.config import PipelineConfig
from structure_from_motion_tpu_torch.device import (
    fetch,
    generator,
    repeat_each,
    stable_topk,
    to_device,
)
from structure_from_motion_tpu_torch.models import global_ba, tracks
from structure_from_motion_tpu_torch.models.tracks import (
    EvictionArchive,
    SfMState,
    _lane,
    lanewise,
)
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
from structure_from_motion_tpu_torch.ops.pnp import PnPDraws, PnPResult, estimate_pnp
from structure_from_motion_tpu_torch.ops.ransac import draw_uniform, sample_index_sets
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
from structure_from_motion_tpu_torch.utils.control import graphed, lane_map, switch, take
from structure_from_motion_tpu_torch.utils.geometry import (
    camera_projection,
    normalized_camera_coords,
    normalized_camera_coords_per_obs,
)
from structure_from_motion_tpu_torch.utils.rotations import quat_to_rotation, rotation_to_quat

# generator streams per frame: match-stage F-gate, then the stage's draws
_STREAM_MATCH, _STREAM_STAGE, _STREAM_STAGE_B = 0, 1, 2


class FrameDraws(NamedTuple):
    """Every uniform a frame program may use, drawn beforehand (an exported
    program takes its draws as inputs; it cannot hold a generator), each
    with its lane axis: the F-gate's (B, V, H, K) (None without the gate),
    the bootstrap's two F draws (B, H, K), and PnP's :class:`PnPDraws` at
    every rung of its bucket ladder. The same accessors as
    :class:`LazyDraws`."""

    gate: torch.Tensor | None
    boot: tuple
    pnp: tuple

    def gate_source(self):
        return self.gate

    def boot_source(self, k: int):
        return self.boot[k]

    def pnp_source(self, rung: int):
        return self.pnp[rung]


class LazyDraws:
    """The live engine's draws, made when a stage asks: each from fresh
    generators, one a lane, seeded from ``(seed, frame, stream)``, so a PnP
    rung draws the same whichever other rungs were drawn, and a live frame
    draws only the rung it takes. :meth:`materialize` draws them all."""

    def __init__(self, seeds, frame: int, device):
        self.seeds, self.frame, self.device = [int(s) for s in seeds], int(frame), device

    def _gens(self, stream: int) -> list:
        return [generator(self.device, s, self.frame, stream) for s in self.seeds]

    def gate_source(self):
        return self._gens(_STREAM_MATCH)

    def boot_source(self, k: int):
        return self._gens((_STREAM_STAGE, _STREAM_STAGE_B)[k])

    def pnp_source(self, rung: int):
        return self._gens(_STREAM_STAGE)

    def materialize(self, config: PipelineConfig, bootstrap: bool = True) -> FrameDraws:
        """Every draw a frame program of ``config`` may use, as a frame
        whose stage takes it draws it (~59 M floats a lane at the CLI's
        default config, mostly PnP's hypotheses at its three rungs); with
        ``bootstrap=False`` none of the bootstrap's (a steady frame's)."""
        cap = config.capacity
        V, Kk, dev = cap.max_views, cap.max_keypoints, self.device
        gate = None
        if config.matcher.use_fundamental_gate:
            gate = draw_uniform(self.gate_source(),
                                (V, config.matcher.gate_ransac.num_hypotheses, Kk), dev)
        hf = config.fundamental_ransac.num_hypotheses
        boot = tuple(draw_uniform(self.boot_source(k), (hf, Kk), dev)
                     for k in ((0, 1) if bootstrap else ()))
        rc = config.pnp_ransac
        pnp = []
        for rung, n in enumerate(_pnp_ladder(config)):
            gens = self.pnp_source(rung)
            sub = draw_uniform(gens, (n,), dev) if 0 < rc.score_subset < n else None
            pnp.append(PnPDraws(sub=sub, hyp=draw_uniform(gens, (rc.num_hypotheses, n), dev)))
        return FrameDraws(gate=gate, boot=boot, pnp=tuple(pnp))


def _match_stage(st: SfMState, v, gate, config: PipelineConfig) -> SfMState:
    """Every lane's view v against its prior views: ONE B3 launch for all
    lanes and views, then the per-view F-gate RANSAC with a (lane, view)
    batch, only for views with enough matches, and the matches recorded.
    ``gate``: the F-gate's uniforms (B, V, H, K), or generators one a lane
    (``draws.gate_source()``); None without the gate."""
    B, V = st.kp_desc.shape[:2]
    prior = torch.arange(V, device=st.kp_desc.device) < v
    res = match_descriptors(st.kp_desc, take(st.kp_desc, v, 1), st.kp_valid & prior[:, None],
                            take(st.kp_valid, v, 1), config.matcher)
    valid = res.valid
    if config.matcher.use_fundamental_gate:
        rc = config.matcher.gate_ransac
        ar = torch.arange(B, device=valid.device)[:, None, None]
        que_xy = take(st.kp_xy, v, 1)[ar, res.target.clamp_min(0).long()]  # (B, V, K, 2)
        idx_sets = sample_index_sets(gate, valid, rc.num_hypotheses, 8)
        gate = find_fundamental(idx_sets, st.kp_xy, que_xy, valid, rc)
        # only gate views with enough matches for a meaningful model
        enough = valid.sum(-1, keepdim=True) >= 16
        valid = torch.where(enough, valid & gate.inliers, valid)
    return tracks.record_matches(st, v, res.target, valid & prior[:, None])


def _front(st: SfMState, v, gate, frame, *, config: PipelineConfig) -> SfMState:
    """A frame up to its stage: ``frame`` an image ((H, W) for a stack of
    one lane, (B, H, W) for B) that is detected here, or the lanes'
    features ``(xy, desc, valid)``; stored at slot v (undistorted first
    when the config has lens distortion), then matched."""
    if torch.is_tensor(frame):
        kps, desc = detect_and_describe(frame, config.frontend)
        xy, valid = kps.xy, kps.mask
        if frame.dim() == 2:
            xy, desc, valid = xy[None], desc[None], valid[None]
    else:
        xy, desc, valid = frame
    if any(config.distortion):
        # known lens distortion: undistort the measurements ONCE at ingest,
        # so that every later residual is the pinhole residual
        xy = lane_map(lambda x, K: undistort_pixels(x, K, config.distortion), xy,
                      take(st.K, v, 1))
    st = tracks.set_view_features(st, v, xy, desc, valid)
    return _match_stage(st, v, gate, config)


def _front_stage(st: SfMState, v, draws, frame, config: PipelineConfig,
                 graphs: dict | None = None) -> SfMState:
    """:func:`_front` with the F-gate's uniforms drawn first (the live
    engine's generators draw eagerly: a CUDA graph would replay one draw
    forever), as ONE ``utils/control.graphed`` call kept in ``graphs`` (the
    engine's): from image (or features) to the recorded matches no host
    read is made. The slot goes in as a 0-dim device tensor (a fill, no
    upload), so every frame of one engine has one key: on the card frame 0
    captures the graph and every later frame replays it (a steady frame's
    graph holds this stage inline)."""
    if not torch.is_tensor(v):
        v = torch.full((), v, dtype=torch.long, device=st.points.device)
    gate = None
    if config.matcher.use_fundamental_gate:
        gate = draws.gate_source()
        if not torch.is_tensor(gate):
            _, V, Kk = st.tri_index.shape
            gate = draw_uniform(gate, (V, config.matcher.gate_ransac.num_hypotheses, Kk),
                                st.points.device)
    return graphed(functools.partial(_front, config=config), st, v, gate, frame, calls=graphs)


def _cos_parallax(X, Ca, Cb):
    ra, rb = X - Ca, X - Cb
    norms = torch.linalg.norm(ra, dim=-1) * torch.linalg.norm(rb, dim=-1)
    return (ra * rb).sum(-1) / norms.clamp_min(1e-12)


def _two_view_candidates(F, K0, K1, q0, C0, ref_xy, que_xy, valid):
    """One lane's pose candidates from F (vmapped): the four (R, C) of E,
    cheirality, and the winner to refine."""
    cands = decompose_essential(essential_from_fundamental(F, K0, K1))
    P_ref = camera_projection(K0, quat_to_rotation(q0), C0)
    P_cands = candidate_projections(K1, cands)
    uv = torch.stack([ref_xy, que_xy], dim=1)
    obs_mask = torch.stack([valid, valid], dim=1)
    X4 = torch.stack([linear_triangulate(torch.stack([P_ref, P_cands[i]]), uv, obs_mask)
                      for i in range(4)])
    best, counts, cheir_ok = disambiguate_poses(P_ref, P_cands, X4, valid)
    return take(cands.R, best), take(cands.t, best), P_ref, counts, cheir_ok


def _pair_points(P_ref, K1, R1, C1, ref_xy, que_xy, valid):
    """One lane's refined pair of projections and its points (vmapped)."""
    P_pair = torch.stack([P_ref, camera_projection(K1, R1, C1)])
    uv = torch.stack([ref_xy, que_xy], dim=1)
    obs_mask = torch.stack([valid, valid], dim=1)
    return P_pair, linear_triangulate(P_pair, uv, obs_mask)


def _two_view_geometry(F, inliers, K0, K1, q0, C0, ref_xy, que_xy, valid):
    """Every lane's pose from F: the four (R, C) candidates, cheirality,
    and the essential-manifold refinement of the winner (its iterations
    one loop for all lanes, each step vmapped)."""
    R0, t0, P_ref, counts, cheir_ok = lane_map(_two_view_candidates, F, K0, K1, q0, C0, ref_xy,
                                                que_xy, valid)
    R1, _, C1 = refine_relative_pose(
        R0, t0, lane_map(normalized_camera_coords, K0, ref_xy),
        lane_map(normalized_camera_coords, K1, que_xy), valid & inliers, lanes=True,
    )
    P_pair, X2 = lane_map(_pair_points, P_ref, K1, R1, C1, ref_xy, que_xy, valid)
    return R1, C1, P_pair, X2, counts, cheir_ok


def _bootstrap_once(st: SfMState, gens, config: PipelineConfig):
    B, _, Kk = st.tri_index.shape
    ref_keys, que_keys, ref_xy, que_xy, valid = tracks.matched_pair_arrays(st, 0, 1)
    rc = config.fundamental_ransac
    F = find_fundamental(sample_index_sets(gens, valid, rc.num_hypotheses, 8),
                         ref_xy, que_xy, valid, rc)
    R1, C1, P_pair, X2, counts, cheir_ok = _two_view_geometry(
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


def _bucket_index(count, ladder: list):
    """Index of the smallest rung of the ladder that holds ``count`` (an int,
    or a 0-dim tensor that the :func:`~..utils.control.switch` over the
    rungs reads)."""
    return sum(count <= n for n in ladder[1:])


def _bucket_size(count: int, ladder: list) -> int:
    """Smallest rung of the ladder that holds ``count``."""
    return ladder[_bucket_index(count, ladder)]


def _pnp_ladder(config: PipelineConfig) -> list:
    """The PnP (and triangulation) bucket ladder over the V * K candidates."""
    N = config.capacity.max_views * config.capacity.max_keypoints
    return _bucket_ladder(N, floor=2048) if config.localize_bucketing else [N]


def _pack_indices(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the valid entries first, in original order, padded with the
    masked-out leftovers to length ``n`` (each lane its own)."""
    N = mask.shape[-1]
    score = torch.where(mask, (N - torch.arange(N, device=mask.device)).to(torch.float32), 0.0)
    return stable_topk(score, n)[1]


def _filled(like: torch.Tensor, v) -> torch.Tensor:
    """``like``-shaped integers all equal to the slot ``v`` (int or 0-dim)."""
    return torch.zeros_like(like) + v


def _pnp_rung(draws, X3d, uv, K_v, mask, prior_R, prior_C, *, rung: int, n: int,
              config: PipelineConfig) -> PnPResult:
    """PnP of every lane on its first ``n`` packed candidates (rung
    ``rung`` of the ladder), inliers scattered back to all N."""
    B, N = mask.shape
    ar = _lane(B, mask.device)
    sel = _pack_indices(mask, n)
    sub = estimate_pnp(draws.pnp_source(rung), X3d[ar, sel], uv[ar, sel], K_v, mask[ar, sel],
                       config.pnp_ransac, config.pnp_lm, prior_R=prior_R, prior_C=prior_C)
    inliers = torch.zeros((B, N), dtype=torch.bool, device=mask.device)
    inliers[ar, sel] = sub.inliers
    return PnPResult(R=sub.R, C=sub.C, inliers=inliers, num_inliers=sub.num_inliers)


def _localize_stage(st: SfMState, v, draws, config: PipelineConfig):
    """PnP of every lane's view v against the union of its prior views'
    2D-3D matches at ONE shared bucket (a switch: an IF node a rung in the
    frame's graph, one host read eagerly), then the localised observations
    and the triangulation of new matches."""
    B, V, Kk = st.tri_index.shape
    dev = st.points.device
    ar = _lane(B, dev)
    targets = take(st.match_table, v, 2)  # (B, V, K)
    valid_m = targets >= 0
    flat_pt = st.tri_index.clamp_min(0).reshape(B, -1).long()
    flat_tgt = targets.clamp_min(0).reshape(B, -1).long()
    flat_mask = (valid_m & (st.tri_index >= 0)).reshape(B, -1)
    X3d = st.points[ar, flat_pt]
    uv_v_all = take(st.kp_xy, v, 1)[ar, flat_tgt]
    prior_R = quat_to_rotation(take(st.cam_q, v - 1, 1))
    prior_C = take(st.cam_C, v - 1, 1)
    N = V * Kk
    K_v = take(st.K, v, 1)
    ladder = _pnp_ladder(config)
    operands = (draws, X3d, uv_v_all, K_v, flat_mask, prior_R, prior_C)
    if len(ladder) > 1:
        pnp = switch(_bucket_index(flat_mask.sum(1).max(), ladder),
                     [functools.partial(_pnp_rung, rung=r, n=n, config=config)
                      for r, n in enumerate(ladder)], *operands)
    else:
        pnp = estimate_pnp(draws.pnp_source(0), X3d, uv_v_all, K_v, flat_mask,
                           config.pnp_ransac, config.pnp_lm, prior_R=prior_R, prior_C=prior_C)
    st = tracks.set_camera(st, v, pnp.C, rotation_to_quat(pnp.R))

    # one observation per map point, from the most recent view's match
    obs_ok = flat_mask & pnp.inliers
    M = st.points.shape[1]
    order = torch.arange(N, device=dev).expand(B, N)
    latest = torch.full((B * M,), -1, dtype=torch.long, device=dev)
    latest.scatter_reduce_(0, (torch.where(obs_ok, flat_pt, M - 1) + ar * M).reshape(-1),
                           torch.where(obs_ok, order, -1).reshape(-1), "amax")
    obs_ok = obs_ok & (latest.view(B, M)[ar, flat_pt] == order)
    st = tracks.append_observations(st, _filled(flat_pt, v), flat_pt, uv_v_all, obs_ok)
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


def _triangulate_new_flat(st: SfMState, v, P_v, flat_tgt, valid_m, config: PipelineConfig):
    """Triangulate every not-yet-constructed match (u, v, k) of every lane,
    one candidate per v-key (the earliest u), at ONE shared bucket, gated by
    cheirality, reprojection error and parallax, and register points and
    observations."""
    B, V, Kk = st.tri_index.shape
    N = V * Kk
    dev = flat_tgt.device
    ar = _lane(B, dev)
    u_idx = repeat_each(torch.arange(V, device=dev), Kk)
    u_free = (st.tri_index < 0).reshape(B, -1)
    v_free = take(st.tri_index, v, 1)[ar, flat_tgt] < 0
    usable = (u_idx < v) & st.cam_valid[:, u_idx]
    cand = valid_m.reshape(B, -1) & u_free & v_free & usable
    first_u = torch.full((B * Kk,), V, dtype=torch.long, device=dev)
    first_u.scatter_reduce_(0, (flat_tgt + ar * Kk).reshape(-1),
                            torch.where(cand, u_idx, V).reshape(-1), "amin")
    cand = cand & (first_u.view(B, Kk)[ar, flat_tgt] == u_idx)

    ladder = _pnp_ladder(config)
    operands = (st, v, P_v, flat_tgt, cand)
    if len(ladder) > 1:
        return switch(_bucket_index(cand.sum(1).max(), ladder),
                      [functools.partial(_admit_new, n=n, packed=True, config=config)
                       for n in ladder], *operands)
    return _admit_new(*operands, n=N, packed=False, config=config)


def _admit_new(st: SfMState, v, P_v, flat_tgt, cand, *, n: int, packed: bool,
               config: PipelineConfig) -> SfMState:
    """:func:`_triangulate_new_flat` at bucket ``n``: the first ``n`` packed
    candidates of each lane (all of them, in place, when not ``packed``)."""
    B, V, Kk = st.tri_index.shape
    N = V * Kk
    dev = flat_tgt.device
    ar = _lane(B, dev)
    u_idx = repeat_each(torch.arange(V, device=dev), Kk)
    ref_keys = torch.arange(Kk, device=dev).repeat(V)
    P_all = camera_projection(st.K, quat_to_rotation(st.cam_q), st.cam_C)  # (B, V, 3, 4)
    ref_xy_full = st.kp_xy.reshape(B, N, 2)
    que_xy_full = take(st.kp_xy, v, 1)[ar, flat_tgt]
    sel = _pack_indices(cand, n) if packed else torch.arange(N, device=dev).expand(B, N)
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
    enough_parallax = _cos_parallax(X3, st.cam_C[ar, u_s], take(st.cam_C, v, 1)[:, None]) \
        < math.cos(math.radians(config.min_parallax_deg))
    keep = cand_s & (d_u > 0) & (d_v > 0) & small.reshape(B, n) & enough_parallax
    # every recording gates on `stored` (keep minus capacity overflow)
    st, ids, stored = tracks.allocate_points(st, X3, keep)
    st = tracks.set_tri_index_flat(st, u_s, ref_keys[sel], ids, stored)
    st = tracks.set_tri_index(st, v, tgt_s, ids, stored)
    st = tracks.append_observations(st, u_s, ids, ref_xy, stored)
    return tracks.append_observations(st, _filled(ids, v), ids, que_xy, stored)


def _ba_ladder(M: int, O: int) -> list:
    """(points, observations) halving ladder for BA bucketing."""
    ladder = [(M, O)]
    while len(ladder) < 4:
        m, o = ladder[-1]
        if m % 2 or o % 2 or m // 2 < 256 or o // 2 < 1024:
            break
        ladder.append((m // 2, o // 2))
    return ladder


def _ba_bucket_index(ladder: list, n_pts, n_obs):
    """Index of the smallest (points, observations) rung that holds both
    live counts (ints, or 0-dim tensors for the switch)."""
    return sum((n_pts <= m) & (n_obs <= o) for m, o in ladder[1:])


def _ba_bucket(ladder: list, n_pts: int, n_obs: int) -> tuple:
    """Smallest (points, observations) rung that holds both live counts."""
    return ladder[_ba_bucket_index(ladder, n_pts, n_obs)]


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


def _ba_rung(st: SfMState, *, m: int, o: int, config: PipelineConfig):
    """Bundle adjustment of every lane on the prefix of ``m`` points and
    ``o`` observations -> (state, costs). A rung too small for the live
    counts runs only where every rung does (``utils/control.device_form``,
    the pass before a CUDA graph's capture), its results unread: its
    observations of points past the prefix are dropped, their ids clamped
    into it (JAX's clamping gather). On the rung the switch takes every id
    is inside the prefix, and the values, and so the bits, are the
    observations' own."""
    B = st.points.shape[0]
    cam_o = st.obs_cam[:, :o]
    pt_o = st.obs_pt[:, :o]
    ba_state = BAState(C=st.cam_C, q=st.cam_q, X=st.points[:, :m], cam_valid=st.cam_valid,
                       pt_valid=st.pt_valid[:, :m])
    obs = BAObservations(
        cam=cam_o,
        point=pt_o.clamp(max=m - 1),
        uv_norm=normalized_camera_coords_per_obs(st.K[_lane(B, st.K.device), cam_o.long()],
                                                 st.obs_uv[:, :o]),
        valid=st.obs_valid[:, :o] & (pt_o < m),
    )
    out, costs = run_bundle_adjustment(ba_state, obs, config.ba)
    points = st.points.clone()
    points[:, :m] = out.X
    return st._replace(cam_C=out.C, cam_q=out.q, points=points), costs


@lanewise
def _ba_stage(st: SfMState, config: PipelineConfig):
    """Bundle adjustment of every lane over all its valid views, points and
    observations at ONE shared prefix bucket holding the largest live counts
    (a switch, as PnP's; one B4 launch an LM iteration for all lanes), or sharded
    over ``config.ba_num_shards`` ranks (one lane), then pruning. Returns
    (state, costs, dropped_obs, pruned_obs, pruned_points)."""
    if config.ba_num_shards > 1:
        return _prune(config, *_sharded_ba(st, config))
    B, M = st.points.shape[:2]
    ladder = _ba_ladder(M, st.obs_cam.shape[1]) if config.ba_bucketing else []
    if len(ladder) > 1:
        index = _ba_bucket_index(ladder, st.num_points.max(), st.num_obs.max())
        st, costs = switch(index, [functools.partial(_ba_rung, m=m, o=o, config=config)
                                   for m, o in ladder], st)
    else:
        st, costs = _ba_rung(st, m=M, o=st.obs_cam.shape[1], config=config)
    return _prune(config, st, costs, torch.zeros(B, dtype=torch.int32, device=st.points.device))


def _prune(config: PipelineConfig, st: SfMState, costs, dropped):
    """The pruning after a BA -> :func:`_ba_stage`'s five results."""
    pruned_obs = pruned_pts = torch.zeros_like(dropped)
    if config.prune_max_error_px > 0:
        st, pruned_obs, pruned_pts = tracks.prune_observations(st, config.prune_max_error_px)
    return st, costs, dropped, pruned_obs, pruned_pts


# a frame's statistics, in the order an exported frame program returns them
INFO_KEYS = ("matches", "f_inliers", "cheirality_counts", "pnp_candidates", "pnp_inliers",
             "new_points", "ba_costs", "ba_dropped_obs", "pruned_obs", "pruned_points",
             "reprojection_px", "dropped_points", "dropped_obs")


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


def _stage_info(st: SfMState, config: PipelineConfig, **found) -> dict:
    """:func:`_zero_info` with a stage's statistics in, each in the type
    and shape every stage returns (the stage switch needs one structure)."""
    info = _zero_info(st, config)
    info.update({k: t.to(info[k].dtype).expand_as(info[k]) for k, t in found.items()})
    return info


def _first_view(st: SfMState, v, draws, *, config: PipelineConfig):
    """Frame 0: pin view 0 at the origin."""
    B = st.points.shape[0]
    dt, dev = st.cam_C.dtype, st.points.device
    st = tracks.set_camera(st, 0, torch.zeros((B, 3), dtype=dt, device=dev),
                           torch.eye(4, dtype=dt, device=dev)[0].expand(B, 4))
    return st, _stage_info(st, config)


def _second_view(st: SfMState, v, draws, *, config: PipelineConfig):
    """Frame 1: the two-view bootstrap."""
    st, si = _bootstrap_stage(st, draws.boot_source(0), draws.boot_source(1), config)
    return st, _stage_info(st, config, **si)


def _later_view(st: SfMState, v, draws, *, config: PipelineConfig):
    """Frames 2 and later: localise view v, triangulate, bundle-adjust."""
    st, si = _localize_stage(st, v, draws, config)
    st, costs, dropped, pruned_o, pruned_p = _ba_stage(st, config)
    return st, _stage_info(st, config, **si, ba_costs=costs, ba_dropped_obs=dropped,
                           pruned_obs=pruned_o, pruned_points=pruned_p)


def _frame_body(st: SfMState, v, draws, frame, *, stage, config: PipelineConfig,
                graphs: dict | None = None):
    """:func:`_front_stage` (its graph kept in ``graphs``), the stage
    ``stage`` (an int, or a 0-dim tensor a :func:`~..utils.control.switch`
    reads) and the frame's metrics."""
    st = _front_stage(st, v, draws, frame, config, graphs)
    stages = [functools.partial(fn, config=config)
              for fn in (_first_view, _second_view, _later_view)]
    st, info = switch(stage, stages, st, v, draws)
    info["reprojection_px"] = tracks.reprojection_error(st)
    info["dropped_points"] = st.dropped_points
    info["dropped_obs"] = st.dropped_obs
    return st, info


def _frame_step(st: SfMState, v, draws, frame, config: PipelineConfig,
                graphs: dict | None = None):
    """One frame at slot ``v`` (a Python int, or a 0-dim int64 tensor in an
    exported program) for every lane: :func:`_front_stage` (detect when
    ``frame`` is an image, store the features, match against all prior
    views), then the v == 0 / bootstrap / localise + BA stage (a
    :func:`~..utils.control.switch` on ``min(v, 2)``), and the reprojection
    metric. ``frame`` carries the lane axis but for a single (H, W) image;
    ``draws`` is a :class:`LazyDraws` or :class:`FrameDraws`; ``graphs`` is
    the engine's dict of CUDA graphs (``utils/control.graphed``).

    A steady frame (an int slot >= 2, unsharded BA) is ONE
    ``utils/control.graphed`` call, as the JAX package's frame is one
    jitted program: the slot goes in as a 0-dim device tensor (a fill) and
    the draws as :meth:`LazyDraws.materialize` makes them (every PnP rung
    drawn eagerly: a graph would replay one draw forever), so every steady
    frame of an engine has one key. On the card the first steady frame
    runs once in ``control.device_form`` (every rung of every switch, every
    loop chunk, no host read), is captured (its bucket switches IF nodes,
    its loops WHILE nodes) and replayed; every later one is a replay with
    no host read. Frames 0 and 1 run as they are (detect + match one
    graph)."""
    if torch.is_tensor(v):
        return _frame_body(st, v, draws, frame, stage=v.clamp(max=2), config=config)
    if v < 2 or config.ba_num_shards > 1:  # a sharded BA's gloo calls cannot be captured
        return _frame_body(st, v, draws, frame, stage=min(v, 2), config=config, graphs=graphs)
    slot = torch.full((), v, dtype=torch.long, device=st.points.device)
    if isinstance(draws, LazyDraws):
        draws = draws.materialize(config, bootstrap=False)
    return graphed(functools.partial(_frame_body, stage=2, config=config), st, slot, draws, frame,
                   calls=graphs)


def _one_lane(state: SfMState, v, draws, frame, config: PipelineConfig,
              graphs: dict | None = None):
    """:func:`_frame_step` on one state: a stack of one lane."""
    st, info = _frame_step(tracks.lanes_of(state), v, draws, frame, config, graphs)
    return tracks.lane_state(st, 0), {k: t[0] for k, t in info.items()}


def _single_step(state: SfMState, v, draws, xy, desc, valid, config: PipelineConfig,
                 graphs: dict | None = None):
    """:func:`_frame_step` of one state on its features."""
    return _one_lane(state, v, draws, (xy[None], desc[None], valid[None]), config, graphs)


def _assess_frame(state: SfMState, prev_slot, xy, desc, valid,
                  config: PipelineConfig) -> torch.Tensor:
    """Keyframe statistic: median pixel displacement of the candidate
    frame's descriptor matches against the stored view ``prev_slot`` (the
    last ACCEPTED frame; an int or a 0-dim tensor), without the fundamental
    gate: raw ratio matches are a fine flow estimate before the frame is
    admitted.

    Returns +inf (so the frame is admitted) when fewer than 8 matches exist:
    a scene cut carries new content even with no matched flow."""
    mcfg = dataclasses.replace(config.matcher, use_fundamental_gate=False)
    kp_xy = take(state.kp_xy, prev_slot, 0)
    res = match_descriptors(take(state.kp_desc, prev_slot, 0), desc,
                            take(state.kp_valid, prev_slot, 0), valid, mcfg)
    if any(config.distortion):
        # the STORED keypoints were undistorted at ingest; raw candidate
        # coordinates against them would measure the distortion, not motion.
        # prev_slot's K stands in for the candidate's (a flow statistic)
        xy = undistort_pixels(xy, take(state.K, prev_slot, 0), config.distortion)
    disp = torch.linalg.norm(xy[res.target.clamp_min(0).long()] - kp_xy, dim=-1)
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
    return 0.5 * (take(srt, lo, 0) + take(srt, hi, 0))


def _assess_frame_native(state: SfMState, prev_slot, img, config: PipelineConfig):
    """Detect, then the keyframe statistic: (xy, desc, valid, flow), the
    features reused by the frame step when the frame is admitted."""
    kps, desc = detect_and_describe(img, config.frontend)
    flow = _assess_frame(state, prev_slot, kps.xy, desc, kps.mask, config)
    return kps.xy, desc, kps.mask, flow


def _frame_step_native(state: SfMState, v, draws, img, config: PipelineConfig,
                       graphs: dict | None = None):
    """Frame step with the frontend in front: image -> features -> frame."""
    return _one_lane(state, v, draws, img, config, graphs)


def _finalize_ba(state: SfMState, iterations: int, config: PipelineConfig):
    """The live window's bundle adjustment with ``iterations`` LM
    iterations -> :func:`_ba_stage`'s five results."""
    cfg = dataclasses.replace(config, ba=dataclasses.replace(config.ba, iterations=iterations))
    return _ba_stage(state, cfg)


class IncrementalSfM:
    """Host-side orchestrator; poses and the map stay on ``device``.

    ``frontend="native"`` runs the DoG frontend on the device
    (:meth:`process_image`); ``"precomputed"`` takes external features
    (:meth:`process_features`). ``device`` defaults to ``"cuda"``, which
    runs the hand-written kernels and raises on a machine without a card;
    ``"cpu"`` runs their plain versions, as the tests do.
    ``collect_metrics=False`` leaves each frame's statistics as device
    tensors (no fetch a frame), as the JAX engine does.

    Every device program runs through :attr:`programs` (``frame_step``,
    ``frame_step_native``, ``assess``, ``assess_native``, ``evict``,
    ``reproj``, ``finalize``), so a served engine (``serve.ServedSfM``)
    swaps in exported programs and keeps the window policy, archive and
    keyframe bookkeeping of this class."""

    def __init__(self, config: PipelineConfig, K, frontend: str = "native", seed: int = 0,
                 collect_metrics: bool = True, *, device="cuda"):
        if config.frontend.max_keypoints != config.capacity.max_keypoints:
            raise ValueError("frontend.max_keypoints must equal capacity.max_keypoints")
        if config.ba_num_shards > 1:
            S = config.ba_num_shards
            if config.capacity.max_points % S or config.capacity.max_observations % S:
                raise ValueError("capacity.max_points and max_observations must be divisible "
                                 f"by ba_num_shards={S}")
            make_mesh(S)  # raises, naming torchrun, without a group of S ranks
        self.config = config
        self.collect_metrics = collect_metrics
        self.device = torch.device(device)
        self.state = tracks.init_state(config.capacity, np.asarray(K, np.float32),
                                       desc_dim=config.frontend.descriptor_dim, device=self.device)
        self.frontend = frontend
        self.seed = seed
        self._frame = 0
        self._window = min(config.capacity.max_views, config.window_size)
        # slide mode's evicted views, oldest first, read as host-numpy records
        self._archive = EvictionArchive()
        # keyframe bookkeeping: the input index of every ACCEPTED frame (the
        # identity when keyframe_min_flow_px == 0) and the next input's index
        self._input_index = 0
        self.keyframe_indices: list = []
        # the device programs by the name an exported artifact gives them:
        # (state, slot, draws, features or image), (state, previous slot,
        # features or image), (state), and (state, iterations) for finalize;
        # the frame's CUDA graphs are the engine's own (dropping it frees them)
        self._graphs: dict = {}
        self.programs = {
            "frame_step": functools.partial(_single_step, config=config, graphs=self._graphs),
            "frame_step_native": functools.partial(_frame_step_native, config=config,
                                                   graphs=self._graphs),
            "assess": functools.partial(_assess_frame, config=config),
            "assess_native": functools.partial(_assess_frame_native, config=config),
            "evict": tracks.evict_oldest_view,
            "reproj": tracks.reprojection_error,
            "finalize": functools.partial(_finalize_ba, config=config),
        }

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        """A tensor on the engine's device as it is, a CPU tensor or an array
        by upload; a tensor of another device is refused."""
        if torch.is_tensor(a):
            if a.device.type != "cpu" and a.device != self.state.points.device:
                raise ValueError(f"input on {a.device}, the engine runs on {self.device}")
        else:
            a = torch.as_tensor(np.asarray(a))
        return to_device(a, self.state.points.device, dtype)

    def _draws(self, frame: int) -> LazyDraws:
        return LazyDraws([self.seed], frame, self.state.points.device)

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
            self.state, rec = self.programs["evict"](self.state)
            self._archive.append_device(rec)
            slot = self._window - 1
        if K is not None:
            K = self._to_device(np.asarray(K, np.float32))
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
            feats = []

            def assess(prev):
                *f, flow = self.programs["assess_native"](self.state, prev, img)
                feats.extend(f)
                return flow

            flow = self._keyframe_flow(assess)
            if flow < self.config.keyframe_min_flow_px:
                return self._skip_info(flow)
            return self._admit(*feats, K, flow)
        v = self._frame
        slot = self._begin_frame(v, K)
        if slot is None:
            return {"skipped": True, "frame": v}
        self.state, info = self.programs["frame_step_native"](self.state, slot, self._draws(v),
                                                              img)
        return self._finish_frame(v, info)

    def process_features(self, xy, desc, valid, K=None) -> dict:
        xy, desc = self._to_device(xy, torch.float32), self._to_device(desc, torch.float32)
        valid = self._to_device(valid, torch.bool)
        flow = self._keyframe_flow(
            lambda prev: self.programs["assess"](self.state, prev, xy, desc, valid))
        if flow is not None and flow < self.config.keyframe_min_flow_px:
            return self._skip_info(flow)
        return self._admit(xy, desc, valid, K, flow)

    def _admit(self, xy, desc, valid, K, flow) -> dict:
        """The frame step on device features that passed the keyframe gate."""
        v = self._frame
        slot = self._begin_frame(v, K)
        if slot is None:
            return {"skipped": True, "frame": v}
        self.state, info = self.programs["frame_step"](self.state, slot, self._draws(v), xy,
                                                       desc, valid)
        info = self._finish_frame(v, info)
        if flow is not None:
            info["flow_px"] = flow
        return info

    def _finish_frame(self, v: int, info: dict) -> dict:
        self._frame = v + 1
        self.keyframe_indices.append(self._input_index)
        self._input_index += 1
        info = dict(info, frame=v)
        if self.collect_metrics:
            # every metric in ONE grouped copy and one wait (the JAX package's
            # grouped device_get), not a host read a key
            info.update(fetch({k: val for k, val in info.items() if torch.is_tensor(val)}))
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

        self.state, self._frame, archive, kf = checkpoint.load_state(path, self.device)
        self._archive = EvictionArchive(archive)
        self.keyframe_indices, self._input_index = kf
        return self._frame

    # -- results -------------------------------------------------------------
    def finalize(self, iterations: int = 10):
        """Bundle adjustment of the live window with ``iterations`` LM
        iterations (the per-frame BA runs ``config.ba.iterations``).
        Returns the per-iteration costs."""
        self.state, costs, _, _, _ = self.programs["finalize"](self.state, iterations)
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
        self._archive = EvictionArchive(r._replace(C=C[i], q=q[i])
                                        for i, r in enumerate(self._archive))
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
        return float(self.programs["reproj"](self.state))

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
