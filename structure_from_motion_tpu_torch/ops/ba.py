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
camera-axis reductions (kernels B6 and B8); ``cam_tiers`` (a keyword of
:func:`run_bundle_adjustment`) cuts that view into tiers of cameras by
descending observation count, each with its own row count
(:func:`compute_cam_tiers`), where one row count would pad it past
twice the observations.

The camera block is ``[C (3), q (4)]``, or for a :class:`CalibratedBAState`
(a state with per-camera intrinsics ``intr`` (V, 3) = (f, k1, k2)) the
self-calibrating ``[C, q, f, k1, k2]`` of a BAL problem, its residuals in
pixels (``ops/reproj.py``): every camera-side size below then reads 10 for
7, and the damping is Marquardt's, ``lam diag(A)`` on each block ``A``
(its diagonal clamped below at :data:`MIN_DIAGONAL`, Ceres'
``min_lm_diagonal``), in place of ``lam I``: in pixel units a camera's
diagonal spans ~20 (f) to ~1e10 (q), so no one ``lam`` damps both.

One LM iteration: block assembly (kernel B4 on the card), Schur reduction
onto the cameras, then either a dense Cholesky solve of the (7V, 7V)
reduced system or, from ``pcg_fallback_cameras`` cameras up, matrix-free
block-Jacobi PCG whose matvec runs kernels B5 and B6 on the card and whose
preconditioner's diagonal blocks kernel B8 sums; point
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
from structure_from_motion_tpu_torch.ops.ba_matvec import cam_diag, expand_cam, reduce_cam
from structure_from_motion_tpu_torch.ops.linalg import inv3x3, pcg_solve, solve_psd
from structure_from_motion_tpu_torch.ops.reproj import batched_residual_jacobians
from structure_from_motion_tpu_torch.utils import profiling
from structure_from_motion_tpu_torch.utils.control import fori, put
from structure_from_motion_tpu_torch.utils.rotations import quat_normalize

__all__ = [
    "BAObservations", "BAState", "CalibratedBAState", "ObsLayout", "compute_cam_ell",
    "compute_cam_tiers", "huber_weights", "run_bundle_adjustment", "total_reprojection_cost",
]


class BAState(NamedTuple):
    C: torch.Tensor  # (V, 3) camera centres
    q: torch.Tensor  # (V, 4) quaternions (w, x, y, z)
    X: torch.Tensor  # (M, 3) map points
    cam_valid: torch.Tensor  # (V,) bool
    pt_valid: torch.Tensor  # (M,) bool


class CalibratedBAState(NamedTuple):
    """A state whose cameras also refine their intrinsics (a BAL problem):
    the 10-wide camera block, observations in pixels (principal point at
    0). Internally ``intr`` travels beside a :class:`BAState` as an
    argument of its own."""

    state: BAState
    intr: torch.Tensor  # (V, 3) f, k1, k2


MIN_DIAGONAL = 1e-6  # Marquardt's damping: the floor of each block's diagonal


class BAObservations(NamedTuple):
    cam: torch.Tensor  # (O,) int32
    point: torch.Tensor  # (O,) int32
    uv_norm: torch.Tensor  # (O, 2) normalised camera coords (pixels with intrinsics)
    valid: torch.Tensor  # (O,) bool


class ObsLayout(NamedTuple):
    """How the stream is laid out: tier t owns the next ``n_t`` points with
    ``rows_t`` slots each (ELL is the single tier ``(M, rows)``), then
    ``pad`` invalid alignment slots, then the tail: the last
    ``len(tail_point)`` slots, point-sorted, observation i of it belonging
    to point ``tail_point[i]`` (the hybrid ELL's spill, or the whole CSR
    stream). ``cam_perm``/``cam_mask``: the camera-major view, slot
    ``v * rows + r`` holding the stream index of camera v's r-th
    observation (``rows`` = the view's length over V); with camera tiers
    (:func:`compute_cam_tiers`) ``cam_seg[v]`` is camera v's (first slot,
    rows) instead."""

    tiers: tuple = ()  # ((n_points, rows), ...)
    pad: int = 0
    tail_point: torch.Tensor | None = None  # (T,) point ids of the tail slots
    cam_perm: torch.Tensor | None = None  # (S,) int32
    cam_mask: torch.Tensor | None = None  # (S,) bool
    lanes: int = 0  # B for a lane stack (B, ...) of ELL problems
    cam_seg: torch.Tensor | None = None  # (V, 2) int32 (first slot, rows) a camera


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


def compute_cam_tiers(cam: torch.Tensor, valid: torch.Tensor, n_views: int, tiers: tuple):
    """Camera-major view of a stream cut into camera tiers: cameras ranked
    by descending valid-observation count (stable), tier t holding the next
    ``n_t`` of them at ``rows_t`` slots each. Returns ``(perm, mask, order,
    seg)``: ``perm``/``mask`` (sum n_t rows_t,) as in
    :func:`compute_cam_ell`, ``order`` (V,) the camera id of each rank and
    ``seg`` (V, 2) int32 each camera's (first slot, rows). A camera's
    observations beyond its tier's rows drop from camera reductions."""
    dev = cam.device
    O = cam.shape[0]
    ones = valid.to(torch.int64)
    counts = torch.zeros(n_views, dtype=torch.int64, device=dev).index_add_(0, cam.long(), ones)
    order = torch.sort(-counts, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_views, device=dev)
    rows_r = torch.as_tensor([r for n, r in tiers for _ in range(n)], dtype=torch.int64).to(dev)
    base_r = torch.cumsum(rows_r, 0) - rows_r
    total = sum(n * r for n, r in tiers)
    key = torch.where(valid, cam.long(), n_views)
    by_cam = torch.argsort(key, stable=True)
    cam_s = key[by_cam]
    start = torch.searchsorted(cam_s, torch.arange(n_views + 1, device=dev))
    within = torch.arange(O, device=dev) - start[cam_s.clamp(max=n_views)]
    r_s = rank[cam_s.clamp(max=n_views - 1)]
    keep = valid[by_cam] & (within < rows_r[r_s])
    dest = torch.where(keep, base_r[r_s] + within, total)
    perm = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    mask = torch.zeros(total + 1, dtype=torch.bool, device=dev)
    perm[dest] = by_cam.to(torch.int32)
    mask[dest] = keep
    seg = torch.stack([base_r[rank], rows_r[rank]], dim=1).to(torch.int32)
    return perm[:total], mask[:total], order, seg


def _cam_sum(vals: torch.Tensor, cam: torch.Tensor, n_views: int) -> torch.Tensor:
    """Sum per-slot values into (n_views, ...) camera bins by a one-hot
    product (lane by lane for a lane stack); a layout with a camera-major
    view sums over it in kernels B6 and B8 instead."""
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


def _assemble(state: BAState, obs: BAObservations, config: BAConfig, lay: ObsLayout,
              intr=None):
    """Residuals -> (U, D, W, b_c, b_p, cost); the per-observation stage is
    kernel B4 on CUDA tensors (10-wide camera blocks with ``intr``)."""
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
        None if intr is None else intr[cam].contiguous(),
    )
    return U, _point_sum(DtD, M, lay), W, b_c, _point_sum(bp_o, M, lay), cost


def _damp(A, lam, marquardt: bool):
    """Blocks ``A`` (..., n, n) damped: ``A + lam I``, or Marquardt's ``A +
    lam diag(A)`` (the diagonal clamped below at :data:`MIN_DIAGONAL`);
    ``lam`` one a lane."""
    lam = lam[..., None, None, None]
    if not marquardt:
        return A + lam * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return A + lam * torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1).clamp_min(MIN_DIAGONAL))


def _solve_dense(U, Dinv, W, b_red, obs, pin, lam, lay: ObsLayout, psum=None,
                 marquardt: bool = False):
    """Exact Schur solve: coupling G (M, V, 7, 3) from per-tier one-hot
    products (and the tail's scatter-add), the reduced (7V, 7V) system
    S = U + lam I - G D^-1 G^T (U and the coupling summed over ranks by
    ``psum`` before the damping goes in), pinned cameras as identity rows,
    and a Cholesky solve (one system a lane for a lane stack). A camera
    block of nc = 10 makes these (M, V, 10, 3) and (10V, 10V), damped in
    Marquardt's form with ``marquardt`` (:func:`_damp`)."""
    a = 1 if lay.lanes else 0
    lead = U.shape[:a]
    M, V, nc = Dinv.shape[a], U.shape[a], U.shape[-1]
    dt, dev = U.dtype, U.device
    Gs, off = [], 0
    for n, r in lay.tiers:
        if r == 0:
            Gs.append(torch.zeros(lead + (n, V, nc, 3), dtype=dt, device=dev))
            continue
        ohc = cam_onehot(obs.cam.narrow(a, off, n * r), V, dt).reshape(lead + (n, r, V))
        Wt = W.narrow(a, off, n * r).reshape(lead + (n, r, nc, 3))
        Gs.append(torch.einsum("...ntv,...ntic->...nvic", ohc, Wt))
        off += n * r
    G = torch.cat(Gs, dim=a).narrow(a, 0, M)
    if lay.tail_point is not None:
        T = lay.tail_point.shape[0]
        G = G.index_put((lay.tail_point.long(), obs.cam.narrow(0, obs.cam.shape[0] - T, T).long()),
                        W.narrow(0, W.shape[0] - T, T), accumulate=True)
    GD = torch.einsum("...mvic,...mcd->...mvid", G, Dinv).reshape(lead + (M, V * nc, 3))
    # [v*nc+i, w*nc+j]
    coupling = torch.einsum("...mad,...mbd->...ab", GD, G.reshape(lead + (M, V * nc, 3)))
    if psum is not None:
        U, coupling = psum(U), psum(coupling)
    blocks = torch.einsum("...vij,vw->...viwj", _damp(U, lam, marquardt),
                          torch.eye(V, dtype=dt, device=dev))  # block diagonal
    S = blocks.reshape(lead + (V * nc, V * nc)) - coupling
    pin_c = repeat_each(pin, nc, -1)
    eye = torch.eye(V * nc, dtype=dt, device=dev)
    S = torch.where(pin_c[..., :, None], eye, S)
    S = torch.where(pin_c[..., None, :], torch.where(eye > 0, S, torch.zeros_like(S)), S)
    b_flat = b_red.reshape(lead + (-1,))
    b = torch.where(pin_c, torch.zeros_like(b_flat), b_flat)
    return solve_psd(S, b).reshape(lead + (V, nc))


def _schur_matvec(x, Pinv, U_hat, Dinv, pin, cam, w21, lay: ObsLayout, *, psum=None):
    """One product of the reduced camera system with ``x``: B5 expands x to
    the slots, a point reduction and D^-1 give y, B6 reduces W y back onto
    the cameras over the camera-major view (and ``psum`` sums it over
    ranks); S is never formed. Pinned cameras are identity rows."""
    xz = x.masked_fill(pin[:, None], 0.0)
    t = expand_cam(cam, w21, xz.contiguous())  # G^T x per slot
    y = torch.einsum("mcd,md->mc", Dinv, _point_sum(t, Dinv.shape[0], lay))  # D^-1 G^T x
    coup = reduce_cam(w21, _point_gather(y, lay).contiguous(), lay.cam_perm, lay.cam_mask,
                      U_hat.shape[0], lay.cam_seg)
    if psum is not None:
        coup = psum(coup)
    # the U_hat x term reads the already summed U_hat: outside the sum
    out = torch.einsum("vij,vj->vi", U_hat, xz) - coup
    return torch.where(pin[:, None], x, out)


def _block_jacobi(r, Pinv, *_):
    return torch.einsum("vij,vj->vi", Pinv, r)


def _solve_pcg(U, Dinv, W, b_red, obs, pin, lam, config: BAConfig, lay: ObsLayout,
               cg_iters: list | None, psum=None, marquardt: bool = False):
    """Matrix-free block-Jacobi PCG on the reduced camera system
    (:func:`_schur_matvec`). The preconditioner inverts the exact 7x7 (or
    10x10) diagonal blocks of S. On one device each chunk of CG iterations
    is one CUDA graph replay on the card; the sharded solve (``psum``) runs
    them eagerly, as its all-reduce cannot be captured."""
    V, nc = U.shape[0], U.shape[-1]
    eye_c = torch.eye(nc, dtype=U.dtype, device=U.device)
    U_hat = _damp(psum(U) if psum is not None else U, lam, marquardt)
    w21 = W.reshape(-1, 3 * nc)
    # exact diagonal blocks: sum over each camera's observations of
    # W_o Dinv_pt(o) W_o^T (at most one observation per (camera, point)),
    # kernel B8 over the camera-major view
    S_diag = cam_diag(w21, Dinv.contiguous(), obs.point.contiguous(), lay.cam_perm, lay.cam_mask,
                      V, lay.cam_seg)
    if psum is not None:
        S_diag = psum(S_diag)
    P = torch.where(pin[:, None, None], eye_c, U_hat - S_diag)
    Pinv, _ = torch.linalg.inv_ex(P)
    b = b_red.masked_fill(pin[:, None], 0.0)
    return pcg_solve(functools.partial(_schur_matvec, psum=psum), b, config.pcg_iterations,
                     precond=_block_jacobi, cg_iters=cg_iters,
                     operands=(Pinv, U_hat, Dinv, pin, obs.cam.contiguous(), w21, lay),
                     capture=psum is None)


def _reduce_and_solve(U, D, W, b_c, b_p, state: BAState, obs, config: BAConfig, lam,
                      lay: ObsLayout, cg_iters: list | None, psum=None, marquardt: bool = False):
    """Schur reduction + reduced camera solve + point back-substitution;
    ``psum`` sums the reduced system's parts over ranks; ``marquardt``
    damps every block in Marquardt's form (:func:`_damp`)."""
    V = state.C.shape[-2]
    dt = state.X.dtype
    Dinv = inv3x3(_damp(D, lam, marquardt)) * state.pt_valid[..., None, None].to(dt)
    y = torch.einsum("...mcd,...md->...mc", Dinv, b_p)
    if lay.cam_perm is not None:  # kernel B6 over the camera-major view
        b_red = b_c - reduce_cam(W.flatten(-2), _point_gather(y, lay).contiguous(), lay.cam_perm,
                                 lay.cam_mask, V, lay.cam_seg)
    else:
        contrib = torch.einsum("...oic,...oc->...oi", W, _point_gather(y, lay))
        b_red = b_c - _cam_sum(contrib, obs.cam, V)
    if psum is not None:
        b_red = psum(b_red)
    pin = ~state.cam_valid
    if config.fix_first_camera_gauge:
        pin = pin.clone()
        pin[..., 0] = True
    if V >= config.pcg_fallback_cameras:
        dc = _solve_pcg(U, Dinv, W, b_red, obs, pin, lam, config, lay, cg_iters, psum, marquardt)
    else:
        b_red = torch.where(pin[..., None], torch.zeros_like(b_red), b_red)
        dc = _solve_dense(U, Dinv, W, b_red, obs, pin, lam, lay, psum, marquardt)
    t = torch.einsum("...oic,...oi->...oc", W, _take(dc, obs.cam.long()))
    dp = torch.einsum("...mcd,...md->...mc", Dinv, b_p - _point_sum(t, D.shape[-3], lay))
    return dc, dp


def _apply_step(state: BAState, dc, dp) -> BAState:
    cam_ok = state.cam_valid[..., None].to(state.C.dtype)
    pt_ok = state.pt_valid[..., None].to(state.X.dtype)
    return state._replace(
        C=state.C + dc[..., :3] * cam_ok,
        q=quat_normalize(state.q + dc[..., 3:7] * cam_ok),
        X=state.X + dp * pt_ok,
    )


def total_reprojection_cost(state: BAState, obs: BAObservations, huber_delta: float = 0.0,
                            lay: ObsLayout | None = None, psum=None, intr=None) -> torch.Tensor:
    """Sum of (Huber-IRLS-weighted) squared normalised residuals over valid
    observations (squared pixels with the cameras' intrinsics ``intr``);
    with ``lay`` the stream is read in that layout, else by ``obs.point``;
    ``psum`` sums the shards' costs over ranks. A lane stack gives one cost
    a lane."""
    cam = obs.cam.long()
    X = _point_gather(state.X, lay) if lay is not None else _take(state.X, obs.point.long())
    res, _, _ = batched_residual_jacobians(
        _take(state.C, cam).reshape(-1, 3), _take(state.q, cam).reshape(-1, 4),
        X.reshape(-1, 3), obs.uv_norm.reshape(-1, 2),
        None if intr is None else intr[cam])
    w = huber_weights(res, huber_delta) * obs.valid.reshape(-1).to(res.dtype)
    cost = ((res * w[:, None]) ** 2).reshape(cam.shape[:-1] + (-1,)).sum(-1)
    return cost if psum is None else psum(cost)


def _layout(state: BAState, obs: BAObservations, config: BAConfig, cam_tiers: tuple = ()):
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
    if cam_tiers:
        perm, mask, _, seg = compute_cam_tiers(obs.cam, obs.valid, V, tuple(cam_tiers))
        return obs, lay._replace(cam_perm=perm, cam_mask=mask, cam_seg=seg)
    cam_rows = config.cam_rows
    if not cam_rows and V >= config.pcg_fallback_cameras:
        # kernel B6 sums each camera's slots over the camera-major view, so
        # the PCG path always builds one, sized to the busiest camera
        # (one host read per BA call)
        counts = torch.bincount(obs.cam[obs.valid].long(), minlength=V)
        cam_rows = -(-max(int(counts.max()), 1) // 8) * 8
    if cam_rows:
        perm, mask = compute_cam_ell(obs.cam, obs.valid, V, cam_rows)
        lay = lay._replace(cam_perm=perm, cam_mask=mask)
    return obs, lay


def run_bundle_adjustment(state: BAState, obs: BAObservations, config: BAConfig,
                          cg_iters: list | None = None, psum=None, cam_tiers: tuple = ()):
    """``config.iterations`` LM iterations; returns (state, per-iteration
    costs (iterations,)). With ``config.adaptive`` rejected steps roll back
    and grow lambda, accepted ones shrink it (on device, no host sync).
    ``cg_iters``, when given, receives the PCG iteration count of each LM
    iteration that solved by PCG. ``psum`` (the sharded solve; see the
    module's docstring) sums a rank's share of the reduced system over the
    ranks: the state then holds this rank's point shard and the stream its
    observations. A lane stack (see the module's docstring) gives costs
    (B, iterations). ``cam_tiers`` ((n_cams, rows), ...) cuts the
    camera-major view into camera tiers (:func:`compute_cam_tiers`) in
    place of ``config.cam_rows``. A :class:`CalibratedBAState` is solved
    with the 10-wide camera block, on one device and one lane, and comes
    back as one."""
    if isinstance(state, CalibratedBAState):
        if psum is not None or state.state.C.dim() == 3:
            raise NotImplementedError("the self-calibrating camera block runs on one device "
                                      "and one lane")
        base, intr = state
        obs, lay = _layout(base, obs, config, cam_tiers)
        lam = base.X.new_full((), config.damping)
        costs = base.X.new_zeros((config.iterations,))
        C, q, X, intr, _, costs = fori(
            config.iterations,
            functools.partial(_lm_iteration_calibrated, config=config, cg_iters=cg_iters),
            (base.C, base.q, base.X, intr, lam, costs), base.cam_valid, base.pt_valid, obs, lay)
        return CalibratedBAState(base._replace(C=C, q=q, X=X), intr), costs
    if state.C.dim() == 3 and state.C.shape[0] == 1:  # one lane: the call without the axis
        out, costs = run_bundle_adjustment(BAState(*(t[0] for t in state)),
                                           BAObservations(*(t[0] for t in obs)), config, cg_iters,
                                           psum)
        return BAState(*(t[None] for t in out)), costs[None]
    if psum is not None and state.C.dim() == 3:
        raise ValueError("a lane stack of problems is not sharded")
    obs, lay = _layout(state, obs, config, cam_tiers)
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
    """LM iteration ``i`` of the 7-wide block as a :func:`fori` body
    (:func:`_lm_step`)."""
    state = BAState(C=C, q=q, X=X, cam_valid=cam_valid, pt_valid=pt_valid)
    state, _, lam, costs = _lm_step(i, state, None, lam, costs, obs, lay, config, cg_iters, psum)
    return state.C, state.q, state.X, lam, costs


def _lm_iteration_calibrated(i, C, q, X, intr, lam, costs, cam_valid, pt_valid, obs,
                             lay: ObsLayout, *, config: BAConfig, cg_iters):
    """LM iteration ``i`` of the 10-wide block, the intrinsics carried
    beside the state (:func:`_lm_step`)."""
    state = BAState(C=C, q=q, X=X, cam_valid=cam_valid, pt_valid=pt_valid)
    state, intr, lam, costs = _lm_step(i, state, intr, lam, costs, obs, lay, config, cg_iters,
                                       None)
    return state.C, state.q, state.X, intr, lam, costs


def _lm_step(i, state: BAState, intr, lam, costs, obs, lay: ObsLayout, config: BAConfig,
             cg_iters, psum):
    """LM iteration ``i``: assembly, reduced solve, the candidate step, its
    cost in ``costs[..., i]`` and (adaptive) the accept test and lambda;
    run eagerly, the span ``ba.iteration`` (``utils/profiling``). With
    ``intr`` (V, 3) the cameras refine their intrinsics too (the 10-wide
    block, Marquardt's damping). -> (state, intr, lam, costs)."""
    with profiling.span("ba.iteration"):
        U, D, W, b_c, b_p, cost = _assemble(state, obs, config, lay, intr)
        if psum is not None:
            cost = psum(cost)  # the accept test compares global costs
        dc, dp = _reduce_and_solve(U, D, W, b_c, b_p, state, obs, config, lam, lay, cg_iters,
                                   psum, marquardt=intr is not None)
        del U, D, W, b_c, b_p  # dead: freed before the candidate's cost allocates
        cand = _apply_step(state, dc, dp)
        cand_intr = None if intr is None else intr + dc[..., 7:] * state.cam_valid[..., None].to(
            intr.dtype)
        costs = put(costs, i, cost, dim=-1 % costs.dim())
        if not config.adaptive:
            return cand, cand_intr, lam, costs
        accept = total_reprojection_cost(cand, obs, config.huber_delta, lay, psum, cand_intr) \
            < cost

        def pick(a, b):
            return torch.where(accept.reshape(accept.shape + (1,) * (a.dim() - accept.dim())), a,
                               b)

        state = BAState(*(pick(a, b) for a, b in zip(cand, state)))
        intr = None if intr is None else pick(cand_intr, intr)
        lam = torch.clamp(
            torch.where(accept, lam * config.damping_down, lam * config.damping_up),
            config.min_damping, config.max_damping,
        )
        return state, intr, lam, costs
