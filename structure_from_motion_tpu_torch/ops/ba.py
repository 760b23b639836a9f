"""Schur-complement Levenberg-Marquardt bundle adjustment (port of
``structure_from_motion_tpu/ops/ba.py``).

Observations are laid out once per call:

* ``obs_layout="ell"`` (per-frame BA): packed so point m owns ``rows``
  contiguous slots; with ``ell_tail`` > 0 (the sharded global solve, the
  hybrid ELL) a point's observations beyond its ``rows`` spill into a
  point-sorted tail of that many slots with explicit point ids;
* ``obs_layout="tiered"`` (whole-trajectory BA): the stream arrives packed
  by ``models/global_ba.pack_tiered``, points renumbered by descending
  track length and cut into tiers of ``(n_points, rows)``, then padding;
* any other ``obs_layout`` ("csr"): the stream sorted by point id, every
  slot a tail slot.

All are described by :class:`ObsLayout`: tiers (ELL is one tier, CSR one
tier of no rows) whose point-axis reductions are reshape-sums and whose
point gathers are broadcasts, and a tail reduced by ``index_add_`` (on
CUDA in no fixed order) and gathered by index. ``cam_rows`` adds a
camera-major view of the same stream (:func:`compute_cam_ell`) for the
camera-axis reductions.

One LM iteration: block assembly (kernel B4 on the card), Schur reduction
onto the cameras, then either a dense Cholesky solve of the (7V, 7V)
reduced system or, from ``pcg_fallback_cameras`` cameras up, matrix-free
block-Jacobi PCG whose matvec runs kernels B5 and B6 on the card; point
back-substitution; the adaptive accept test on the same Huber objective the
assembly charged.

``psum``: the sharded solve (``parallel/ba_sharded.py``) runs one shard of
the points and their observations in each rank and passes the sum over
ranks. It is applied where the JAX package applies ``lax.psum``: the LM
cost, the reduced right-hand side, ``U`` and the Schur coupling (dense
solve), ``U``, the diagonal blocks and each matvec's coupling (PCG), and
the candidate cost. ``U`` is summed BEFORE ``lam * I`` is added and the
``U_hat @ x`` term of the matvec stays outside the sum, so the damping is
counted once.

A leading lane axis on every field of the state and the observations (the
batched engine's per-frame BA) stacks independent problems: ELL layout,
dense solve, one B4 launch an iteration for all lanes, and each lane
accepting or rejecting its own step with its own lambda, so lane b follows
what the call on lane b's problem alone gives. A stack of one lane is that
call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from structure_from_motion_tpu_torch.config import BAConfig
from structure_from_motion_tpu_torch.device import repeat_each
from structure_from_motion_tpu_torch.ops.ba_cuda import ba_blocks, cam_onehot, huber_weights
from structure_from_motion_tpu_torch.ops.ba_matvec import expand_cam, reduce_cam
from structure_from_motion_tpu_torch.ops.linalg import inv3x3, pcg_solve, solve_psd
from structure_from_motion_tpu_torch.ops.reproj import batched_residual_jacobians
from structure_from_motion_tpu_torch.utils import profiling
from structure_from_motion_tpu_torch.utils.control import fori, put
from structure_from_motion_tpu_torch.utils.rotations import quat_normalize

__all__ = [
    "BAObservations", "BAState", "ObsLayout", "compute_cam_ell", "huber_weights",
    "run_bundle_adjustment", "total_reprojection_cost",
]


class BAState(NamedTuple):
    C: torch.Tensor  # (V, 3) camera centres
    q: torch.Tensor  # (V, 4) quaternions (w, x, y, z)
    X: torch.Tensor  # (M, 3) map points
    cam_valid: torch.Tensor  # (V,) bool
    pt_valid: torch.Tensor  # (M,) bool


class BAObservations(NamedTuple):
    cam: torch.Tensor  # (O,) int32
    point: torch.Tensor  # (O,) int32
    uv_norm: torch.Tensor  # (O, 2) normalised camera coords
    valid: torch.Tensor  # (O,) bool


class ObsLayout(NamedTuple):
    """How the stream is laid out: tier t owns the next ``n_t`` points with
    ``rows_t`` slots each (ELL is the single tier ``(M, rows)``), then
    ``pad`` invalid alignment slots, then the tail: the last
    ``len(tail_point)`` slots, point-sorted, observation i of it belonging
    to point ``tail_point[i]`` (the hybrid ELL's spill, or the whole CSR
    stream). ``cam_perm``/``cam_mask`` (with ``cam_rows`` > 0): slot
    ``v * cam_rows + r`` of the camera-major view holds the stream index of
    camera v's r-th observation."""

    tiers: tuple = ()  # ((n_points, rows), ...)
    pad: int = 0
    tail_point: torch.Tensor | None = None  # (T,) point ids of the tail slots
    cam_rows: int = 0
    cam_perm: torch.Tensor | None = None  # (V * cam_rows,) int32
    cam_mask: torch.Tensor | None = None  # (V * cam_rows,) bool
    lanes: int = 0  # B for a lane stack (B, ...) of ELL problems


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]``; with a lane axis ((B, N, ...) at (B, O)), each lane's rows."""
    if idx.dim() == 1:
        return t[idx]
    return t[torch.arange(t.shape[0], device=t.device)[:, None], idx]


def _sort_obs_by_point(obs: BAObservations) -> BAObservations:
    """The stream in point order (stable): the CSR layout."""
    order = torch.argsort(obs.point, stable=True)
    return BAObservations(*(t[order] for t in obs))


def _to_ell(obs: BAObservations, m: int, rows: int, tail: int = 0) -> BAObservations:
    """Pack into ELL: point p owns slots [p*rows, (p+1)*rows); empty slots
    are invalid (cam 0). Observations beyond a point's ``rows`` spill, in
    point order, into ``tail`` slots after the ELL block, whose point ids
    are explicit (``m - 1`` in the empty ones, so the tail stays sorted);
    without a tail, or past it, they drop (``rows = V`` never drops: at most
    one observation per (view, point)). With a lane axis (no tail) lane b's
    points are numbered from b * m, so one stable pack lays lane after lane,
    each exactly as its own pack would."""
    if obs.cam.dim() == 2:
        B = obs.cam.shape[0]
        off = torch.arange(B, device=obs.cam.device)[:, None] * m
        flat = BAObservations(cam=obs.cam.reshape(-1), point=(obs.point + off).reshape(-1),
                              uv_norm=obs.uv_norm.reshape(-1, 2), valid=obs.valid.reshape(-1))
        packed = BAObservations(*(t.reshape((B, m * rows) + t.shape[1:])
                                  for t in _to_ell(flat, B * m, rows)))
        return packed._replace(point=(packed.point - off).to(torch.int32))
    point = torch.where(obs.valid, obs.point, m).long()
    order = torch.argsort(point, stable=True)
    s_pt, s_cam = point[order], obs.cam[order]
    s_uv, s_valid = obs.uv_norm[order], obs.valid[order]
    start = torch.searchsorted(s_pt, torch.arange(m + 1, device=s_pt.device))
    rank = torch.arange(s_pt.shape[0], device=s_pt.device) - start[s_pt.clamp(max=m)]
    keep = s_valid & (rank < rows)
    total = m * rows + tail
    dest = torch.where(keep, s_pt * rows + rank, total)
    if tail:
        is_tail = s_valid & (rank >= rows)
        tpos = torch.cumsum(is_tail.long(), 0) - 1  # point-sorted order
        keep_tail = is_tail & (tpos < tail)
        dest = torch.where(keep_tail, m * rows + tpos, dest)
        keep = keep | keep_tail
    cam = torch.zeros(total + 1, dtype=torch.int32, device=s_pt.device)
    uv = torch.zeros(total + 1, 2, dtype=s_uv.dtype, device=s_pt.device)
    valid = torch.zeros(total + 1, dtype=torch.bool, device=s_pt.device)
    cam[dest] = s_cam.to(torch.int32)
    uv[dest] = s_uv
    valid[dest] = keep
    point = repeat_each(torch.arange(m, dtype=torch.int32, device=s_pt.device), rows)
    if tail:
        pt_tail = torch.full((total + 1,), m - 1, dtype=torch.int32, device=s_pt.device)
        pt_tail[dest] = s_pt.to(torch.int32)
        point = torch.cat([point, pt_tail[m * rows:total]])
    return BAObservations(cam=cam[:total], point=point, uv_norm=uv[:total], valid=valid[:total])


def compute_cam_ell(cam: torch.Tensor, valid: torch.Tensor, n_views: int, rows: int):
    """Camera-major view of a stream: ``(perm, mask)`` of shape
    (n_views * rows,), slot ``v * rows + r`` indexing camera v's r-th valid
    observation in stream order (mask False on empty slots). ``rows`` below
    a camera's count drops its excess from camera reductions."""
    O = cam.shape[0]
    key = torch.where(valid, cam.long(), n_views)
    order = torch.argsort(key, stable=True)
    cam_s = key[order]
    start = torch.searchsorted(cam_s, torch.arange(n_views + 1, device=cam.device))
    rank = torch.arange(O, device=cam.device) - start[cam_s.clamp(max=n_views)]
    keep = valid[order] & (rank < rows)
    total = n_views * rows
    dest = torch.where(keep, cam_s * rows + rank, total)
    perm = torch.zeros(total + 1, dtype=torch.int32, device=cam.device)
    mask = torch.zeros(total + 1, dtype=torch.bool, device=cam.device)
    perm[dest] = order.to(torch.int32)
    mask[dest] = keep
    return perm[:total], mask[:total]


def _cam_sum(vals: torch.Tensor, cam: torch.Tensor, n_views: int, lay: ObsLayout) -> torch.Tensor:
    """Sum per-slot values into (n_views, ...) camera bins: camera-ELL
    gather + reshape-sum when the layout has one, else a one-hot product
    (lane by lane for a lane stack)."""
    if lay.cam_perm is not None:
        m = lay.cam_mask.to(vals.dtype).reshape((-1,) + (1,) * (vals.dim() - 1))
        g = vals[lay.cam_perm.long()] * m
        return g.reshape((n_views, lay.cam_rows) + vals.shape[1:]).sum(1)
    lead, O = cam.shape[:-1], cam.shape[-1]
    oh = cam_onehot(cam, n_views, vals.dtype)
    out = oh.transpose(-1, -2) @ vals.reshape(lead + (O, -1))
    return out.reshape(lead + (n_views,) + vals.shape[len(lead) + 1:])


def _point_sum(vals: torch.Tensor, m: int, lay: ObsLayout) -> torch.Tensor:
    """Sum per-slot values into (m, ...) point bins: per-tier reshape-sums
    in point order, plus the tail's segment sum; padding slots are
    ignored."""
    a = 1 if lay.lanes else 0  # the slot axis
    lead, rest = vals.shape[:a], vals.shape[a + 1:]
    outs, off = [], 0
    for n, r in lay.tiers:
        if r == 0:
            outs.append(vals.new_zeros(lead + (n,) + rest))
            continue
        outs.append(vals.narrow(a, off, n * r).reshape(lead + (n, r) + rest).sum(a + 1))
        off += n * r
    out = torch.cat(outs, dim=a).narrow(a, 0, m)
    if lay.tail_point is not None:
        T = lay.tail_point.shape[0]
        out = out.index_add(0, lay.tail_point.long(), vals.narrow(0, vals.shape[0] - T, T))
    return out


def _point_gather(vals: torch.Tensor, lay: ObsLayout) -> torch.Tensor:
    """Expand (m, ...) point values to the slot stream (per-tier broadcast;
    padding slots read point 0, whose weight there is zero; the tail by
    index)."""
    a = 1 if lay.lanes else 0  # the point axis
    outs, p0 = [], 0
    for n, r in lay.tiers:
        if r:
            outs.append(repeat_each(vals.narrow(a, p0, n), r, a))
        p0 += n
    if lay.pad:
        outs.append(vals.narrow(a, 0, 1).expand(vals.shape[:a] + (lay.pad,) + vals.shape[a + 1:]))
    if lay.tail_point is not None:
        outs.append(vals[lay.tail_point.long()])
    return torch.cat(outs, dim=a)


def _assemble(state: BAState, obs: BAObservations, config: BAConfig, lay: ObsLayout):
    """Residuals -> (U, D, W, b_c, b_p, cost); the per-observation stage is
    kernel B4 on CUDA tensors."""
    V, M = state.C.shape[-2], state.X.shape[-2]
    cam = obs.cam.long()
    U, b_c, DtD, W, bp_o, cost = ba_blocks(
        obs.cam.contiguous(),
        _take(state.C, cam).contiguous(),
        _take(state.q, cam).contiguous(),
        _point_gather(state.X, lay).contiguous(),
        obs.uv_norm.contiguous(),
        obs.valid.to(state.X.dtype),
        V,
        float(config.huber_delta),
    )
    return U, _point_sum(DtD, M, lay), W, b_c, _point_sum(bp_o, M, lay), cost


def _solve_dense(U, Dinv, W, b_red, obs, pin, lam, lay: ObsLayout, psum=None):
    """Exact Schur solve: coupling G (M, V, 7, 3) from per-tier one-hot
    products (and the tail's scatter-add), the reduced (7V, 7V) system
    S = U + lam I - G D^-1 G^T (U and the coupling summed over ranks by
    ``psum`` before the damping goes in), pinned cameras as identity rows,
    and a Cholesky solve (one system a lane for a lane stack)."""
    a = 1 if lay.lanes else 0
    lead = U.shape[:a]
    M, V = Dinv.shape[a], U.shape[a]
    dt, dev = U.dtype, U.device
    Gs, off = [], 0
    for n, r in lay.tiers:
        if r == 0:
            Gs.append(torch.zeros(lead + (n, V, 7, 3), dtype=dt, device=dev))
            continue
        ohc = cam_onehot(obs.cam.narrow(a, off, n * r), V, dt).reshape(lead + (n, r, V))
        Wt = W.narrow(a, off, n * r).reshape(lead + (n, r, 7, 3))
        Gs.append(torch.einsum("...ntv,...ntic->...nvic", ohc, Wt))
        off += n * r
    G = torch.cat(Gs, dim=a).narrow(a, 0, M)
    if lay.tail_point is not None:
        T = lay.tail_point.shape[0]
        G = G.index_put((lay.tail_point.long(), obs.cam.narrow(0, obs.cam.shape[0] - T, T).long()),
                        W.narrow(0, W.shape[0] - T, T), accumulate=True)
    GD = torch.einsum("...mvic,...mcd->...mvid", G, Dinv).reshape(lead + (M, V * 7, 3))
    # [v*7+i, w*7+j]
    coupling = torch.einsum("...mad,...mbd->...ab", GD, G.reshape(lead + (M, V * 7, 3)))
    if psum is not None:
        U, coupling = psum(U), psum(coupling)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    blocks = torch.einsum("...vij,vw->...viwj", U + lam[..., None, None, None] * eye7,
                          torch.eye(V, dtype=dt, device=dev))  # block diagonal
    S = blocks.reshape(lead + (V * 7, V * 7)) - coupling
    pin7 = repeat_each(pin, 7, -1)
    eye = torch.eye(V * 7, dtype=dt, device=dev)
    S = torch.where(pin7[..., :, None], eye, S)
    S = torch.where(pin7[..., None, :], torch.where(eye > 0, S, torch.zeros_like(S)), S)
    b_flat = b_red.reshape(lead + (-1,))
    b = torch.where(pin7, torch.zeros_like(b_flat), b_flat)
    return solve_psd(S, b).reshape(lead + (V, 7))


def _schur_matvec(x, Pinv, U_hat, Dinv, pin, cam, w21, lay: ObsLayout, *, psum=None):
    """One product of the reduced camera system with ``x``: B5 expands x to
    the slots, a point reduction and D^-1 give y, B6 reduces W y back onto
    the cameras over the camera-major view (and ``psum`` sums it over
    ranks); S is never formed. Pinned cameras are identity rows."""
    xz = x.masked_fill(pin[:, None], 0.0)
    t = expand_cam(cam, w21, xz.contiguous())  # G^T x per slot
    y = torch.einsum("mcd,md->mc", Dinv, _point_sum(t, Dinv.shape[0], lay))  # D^-1 G^T x
    coup = reduce_cam(w21, _point_gather(y, lay).contiguous(), lay.cam_perm, lay.cam_mask,
                      U_hat.shape[0])
    if psum is not None:
        coup = psum(coup)
    # the U_hat x term reads the already summed U_hat: outside the sum
    out = torch.einsum("vij,vj->vi", U_hat, xz) - coup
    return torch.where(pin[:, None], x, out)


def _block_jacobi(r, Pinv, *_):
    return torch.einsum("vij,vj->vi", Pinv, r)


def _solve_pcg(U, Dinv, W, b_red, obs, pin, lam, config: BAConfig, lay: ObsLayout,
               cg_iters: list | None, psum=None):
    """Matrix-free block-Jacobi PCG on the reduced camera system
    (:func:`_schur_matvec`). The preconditioner inverts the exact 7x7
    diagonal blocks of S. On one device each chunk of CG iterations is one
    CUDA graph replay on the card; the sharded solve (``psum``) runs them
    eagerly, as its all-reduce cannot be captured."""
    V = U.shape[0]
    dt = U.dtype
    eye7 = torch.eye(7, dtype=dt, device=U.device)
    U_hat = (psum(U) if psum is not None else U) + lam * eye7
    w21 = W.reshape(-1, 21)
    # exact diagonal blocks: sum over each camera's observations of
    # W_o Dinv_pt(o) W_o^T (at most one observation per (camera, point))
    WD = torch.einsum("oic,ocd->oid", W, _point_gather(Dinv, lay))
    S_diag = _cam_sum(torch.einsum("oid,ojd->oij", WD, W), obs.cam, V, lay)
    if psum is not None:
        S_diag = psum(S_diag)
    P = torch.where(pin[:, None, None], eye7, U_hat - S_diag)
    Pinv, _ = torch.linalg.inv_ex(P)
    b = b_red.masked_fill(pin[:, None], 0.0)
    return pcg_solve(functools.partial(_schur_matvec, psum=psum), b, config.pcg_iterations,
                     precond=_block_jacobi, cg_iters=cg_iters,
                     operands=(Pinv, U_hat, Dinv, pin, obs.cam.contiguous(), w21, lay),
                     capture=psum is None)


def _reduce_and_solve(U, D, W, b_c, b_p, state: BAState, obs, config: BAConfig, lam,
                      lay: ObsLayout, cg_iters: list | None, psum=None):
    """Schur reduction + reduced camera solve + point back-substitution;
    ``psum`` sums the reduced system's parts over ranks."""
    V = state.C.shape[-2]
    dt = state.X.dtype
    Dinv = inv3x3(D + lam[..., None, None, None] * torch.eye(3, dtype=dt, device=D.device)) \
        * state.pt_valid[..., None, None].to(dt)
    y = torch.einsum("...mcd,...md->...mc", Dinv, b_p)
    contrib = torch.einsum("...oic,...oc->...oi", W, _point_gather(y, lay))
    b_red = b_c - _cam_sum(contrib, obs.cam, V, lay)
    if psum is not None:
        b_red = psum(b_red)
    pin = ~state.cam_valid
    if config.fix_first_camera_gauge:
        pin = pin.clone()
        pin[..., 0] = True
    if V >= config.pcg_fallback_cameras:
        dc = _solve_pcg(U, Dinv, W, b_red, obs, pin, lam, config, lay, cg_iters, psum)
    else:
        b_red = torch.where(pin[..., None], torch.zeros_like(b_red), b_red)
        dc = _solve_dense(U, Dinv, W, b_red, obs, pin, lam, lay, psum)
    t = torch.einsum("...oic,...oi->...oc", W, _take(dc, obs.cam.long()))
    dp = torch.einsum("...mcd,...md->...mc", Dinv, b_p - _point_sum(t, D.shape[-3], lay))
    return dc, dp


def _apply_step(state: BAState, dc, dp) -> BAState:
    cam_ok = state.cam_valid[..., None].to(state.C.dtype)
    pt_ok = state.pt_valid[..., None].to(state.X.dtype)
    return state._replace(
        C=state.C + dc[..., :3] * cam_ok,
        q=quat_normalize(state.q + dc[..., 3:] * cam_ok),
        X=state.X + dp * pt_ok,
    )


def total_reprojection_cost(state: BAState, obs: BAObservations, huber_delta: float = 0.0,
                            lay: ObsLayout | None = None, psum=None) -> torch.Tensor:
    """Sum of (Huber-IRLS-weighted) squared normalised residuals over valid
    observations; with ``lay`` the stream is read in that layout, else by
    ``obs.point``; ``psum`` sums the shards' costs over ranks. A lane stack
    gives one cost a lane."""
    cam = obs.cam.long()
    X = _point_gather(state.X, lay) if lay is not None else _take(state.X, obs.point.long())
    res, _, _ = batched_residual_jacobians(
        _take(state.C, cam).reshape(-1, 3), _take(state.q, cam).reshape(-1, 4),
        X.reshape(-1, 3), obs.uv_norm.reshape(-1, 2))
    w = huber_weights(res, huber_delta) * obs.valid.reshape(-1).to(res.dtype)
    cost = ((res * w[:, None]) ** 2).reshape(cam.shape[:-1] + (-1,)).sum(-1)
    return cost if psum is None else psum(cost)


def _layout(state: BAState, obs: BAObservations, config: BAConfig):
    """Canonicalise the stream once per BA call -> (obs, ObsLayout)."""
    V, M = state.C.shape[-2], state.X.shape[-2]
    if state.C.dim() == 3:
        if config.obs_layout != "ell" or config.ell_tail or config.cam_rows \
                or V >= config.pcg_fallback_cameras:
            raise NotImplementedError("a lane stack of problems takes the ELL layout and the "
                                      "dense solve")
        B, rows = state.C.shape[0], config.ell_rows or V
        obs = _to_ell(obs, M, rows)
        # kernel B4 takes a lane stack only in whole rows of 4 observations:
        # each lane's stream ends in empty slots up to the next multiple of 4
        pad = -(M * rows) % 4
        if pad:
            obs = BAObservations(*(torch.cat([t, t.new_zeros((B, pad) + t.shape[2:])], dim=1)
                                   for t in obs))
        return obs, ObsLayout(tiers=((M, rows),), pad=pad, lanes=B)
    if config.obs_layout == "tiered":
        if not config.tiers:
            raise ValueError("obs_layout='tiered' requires config.tiers")
        tiers = tuple(config.tiers)
        lay = ObsLayout(tiers=tiers, pad=obs.cam.shape[0] - sum(n * r for n, r in tiers))
    elif config.obs_layout == "ell":
        rows = config.ell_rows or V
        obs = _to_ell(obs, M, rows, config.ell_tail)
        lay = ObsLayout(tiers=((M, rows),),
                        tail_point=obs.point[M * rows:] if config.ell_tail else None)
    else:  # CSR: every slot a tail slot of the point-sorted stream
        obs = _sort_obs_by_point(obs)
        lay = ObsLayout(tiers=((M, 0),), tail_point=obs.point)
    cam_rows = config.cam_rows
    if not cam_rows and V >= config.pcg_fallback_cameras:
        # kernel B6 sums each camera's slots over the camera-major view, so
        # the PCG path always builds one, sized to the busiest camera
        # (one host read per BA call)
        counts = torch.bincount(obs.cam[obs.valid].long(), minlength=V)
        cam_rows = -(-max(int(counts.max()), 1) // 8) * 8
    if cam_rows:
        perm, mask = compute_cam_ell(obs.cam, obs.valid, V, cam_rows)
        lay = lay._replace(cam_rows=cam_rows, cam_perm=perm, cam_mask=mask)
    return obs, lay


def run_bundle_adjustment(state: BAState, obs: BAObservations, config: BAConfig,
                          cg_iters: list | None = None, psum=None):
    """``config.iterations`` LM iterations; returns (state, per-iteration
    costs (iterations,)). With ``config.adaptive`` rejected steps roll back
    and grow lambda, accepted ones shrink it (on device, no host sync).
    ``cg_iters``, when given, receives the PCG iteration count of each LM
    iteration that solved by PCG. ``psum`` (the sharded solve; see the
    module's docstring) sums a rank's share of the reduced system over the
    ranks: the state then holds this rank's point shard and the stream its
    observations. A lane stack (see the module's docstring) gives costs
    (B, iterations)."""
    if state.C.dim() == 3 and state.C.shape[0] == 1:  # one lane: the call without the axis
        out, costs = run_bundle_adjustment(BAState(*(t[0] for t in state)),
                                           BAObservations(*(t[0] for t in obs)), config, cg_iters,
                                           psum)
        return BAState(*(t[None] for t in out)), costs[None]
    if psum is not None and state.C.dim() == 3:
        raise ValueError("a lane stack of problems is not sharded")
    obs, lay = _layout(state, obs, config)
    lam = torch.full(state.C.shape[:-2], config.damping, dtype=state.X.dtype,
                     device=state.X.device)
    costs = state.X.new_zeros(state.C.shape[:-2] + (config.iterations,))
    C, q, X, _, costs = fori(
        config.iterations,
        functools.partial(_lm_iteration, config=config, cg_iters=cg_iters, psum=psum),
        (state.C, state.q, state.X, lam, costs), state.cam_valid, state.pt_valid, obs, lay)
    return state._replace(C=C, q=q, X=X), costs


def _lm_iteration(i, C, q, X, lam, costs, cam_valid, pt_valid, obs, lay: ObsLayout, *,
                  config: BAConfig, cg_iters, psum):
    """LM iteration ``i``: assembly, reduced solve, the candidate step, its
    cost in ``costs[..., i]`` and (adaptive) the accept test and lambda;
    run eagerly, the span ``ba.iteration`` (``utils/profiling``)."""
    with profiling.span("ba.iteration"):
        state = BAState(C=C, q=q, X=X, cam_valid=cam_valid, pt_valid=pt_valid)
        U, D, W, b_c, b_p, cost = _assemble(state, obs, config, lay)
        if psum is not None:
            cost = psum(cost)  # the accept test compares global costs
        dc, dp = _reduce_and_solve(U, D, W, b_c, b_p, state, obs, config, lam, lay, cg_iters,
                                   psum)
        cand = _apply_step(state, dc, dp)
        costs = put(costs, i, cost, dim=-1 % costs.dim())
        if not config.adaptive:
            return cand.C, cand.q, cand.X, lam, costs
        accept = total_reprojection_cost(cand, obs, config.huber_delta, lay, psum) < cost
        state = BAState(*(torch.where(
            accept.reshape(accept.shape + (1,) * (a.dim() - accept.dim())), a, b)
            for a, b in zip(cand, state)))
        lam = torch.clamp(
            torch.where(accept, lam * config.damping_down, lam * config.damping_up),
            config.min_damping, config.max_damping,
        )
        return state.C, state.q, state.X, lam, costs


