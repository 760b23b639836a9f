"""Schur-complement Levenberg-Marquardt bundle adjustment (port of
``structure_from_motion_tpu/ops/ba.py``, single device).

Observations are laid out so that no LM or CG iteration scatters:

* ``obs_layout="ell"`` (per-frame BA): packed once per call so point m owns
  ``rows`` contiguous slots;
* ``obs_layout="tiered"`` (whole-trajectory BA): the stream arrives packed
  by ``models/global_ba.pack_tiered``, points renumbered by descending
  track length and cut into tiers of ``(n_points, rows)``, then padding.

Both are described by :class:`ObsLayout` tiers (ELL is one tier), so every
point-axis reduction is a per-tier reshape-sum and every point gather a
broadcast. ``cam_rows`` adds a camera-major view of the same stream
(:func:`compute_cam_ell`) for the camera-axis reductions.

One LM iteration: block assembly (kernel B4 on the card), Schur reduction
onto the cameras, then either a dense Cholesky solve of the (7V, 7V)
reduced system or, from ``pcg_fallback_cameras`` cameras up, matrix-free
block-Jacobi PCG whose matvec runs kernels B5 and B6 on the card; point
back-substitution; the adaptive accept test on the same Huber objective the
assembly charged. The CSR layout and the hybrid-ELL tail serve only the
sharded solve, which is not ported (ROADMAP A13).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_from_motion_tpu_torch.config import BAConfig
from structure_from_motion_tpu_torch.ops.ba_cuda import ba_blocks, cam_onehot, huber_weights
from structure_from_motion_tpu_torch.ops.ba_matvec import expand_cam, reduce_cam
from structure_from_motion_tpu_torch.ops.linalg import inv3x3, pcg_solve, solve_psd
from structure_from_motion_tpu_torch.ops.reproj import batched_residual_jacobians
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
    ``pad`` invalid alignment slots. ``cam_perm``/``cam_mask`` (with
    ``cam_rows`` > 0): slot ``v * cam_rows + r`` of the camera-major view
    holds the stream index of camera v's r-th observation."""

    tiers: tuple = ()  # ((n_points, rows), ...)
    pad: int = 0
    cam_rows: int = 0
    cam_perm: torch.Tensor | None = None  # (V * cam_rows,) int32
    cam_mask: torch.Tensor | None = None  # (V * cam_rows,) bool


def _to_ell(obs: BAObservations, m: int, rows: int) -> BAObservations:
    """Pack into ELL: point p owns slots [p*rows, (p+1)*rows); empty slots
    are invalid (cam 0), and observations beyond a point's ``rows`` drop
    (``rows = V`` never drops: at most one observation per (view, point))."""
    point = torch.where(obs.valid, obs.point, m).long()
    order = torch.argsort(point, stable=True)
    s_pt, s_cam = point[order], obs.cam[order]
    s_uv, s_valid = obs.uv_norm[order], obs.valid[order]
    start = torch.searchsorted(s_pt, torch.arange(m + 1, device=s_pt.device))
    rank = torch.arange(s_pt.shape[0], device=s_pt.device) - start[s_pt.clamp(max=m)]
    keep = s_valid & (rank < rows)
    total = m * rows
    dest = torch.where(keep, s_pt * rows + rank, total)
    cam = torch.zeros(total + 1, dtype=torch.int32, device=s_pt.device)
    uv = torch.zeros(total + 1, 2, dtype=s_uv.dtype, device=s_pt.device)
    valid = torch.zeros(total + 1, dtype=torch.bool, device=s_pt.device)
    cam[dest] = s_cam.to(torch.int32)
    uv[dest] = s_uv
    valid[dest] = keep
    point = torch.arange(m, dtype=torch.int32, device=s_pt.device).repeat_interleave(rows)
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
    gather + reshape-sum when the layout has one, else a one-hot product."""
    if lay.cam_perm is not None:
        m = lay.cam_mask.to(vals.dtype).reshape((-1,) + (1,) * (vals.dim() - 1))
        g = vals[lay.cam_perm.long()] * m
        return g.reshape((n_views, lay.cam_rows) + vals.shape[1:]).sum(1)
    oh = cam_onehot(cam, n_views, vals.dtype)
    return (oh.T @ vals.reshape(vals.shape[0], -1)).reshape((n_views,) + vals.shape[1:])


def _point_sum(vals: torch.Tensor, m: int, lay: ObsLayout) -> torch.Tensor:
    """Sum per-slot values into (m, ...) point bins: per-tier reshape-sums
    in point order; padding slots are ignored."""
    outs, off = [], 0
    for n, r in lay.tiers:
        if r == 0:
            outs.append(vals.new_zeros((n,) + vals.shape[1:]))
            continue
        outs.append(vals[off:off + n * r].reshape((n, r) + vals.shape[1:]).sum(1))
        off += n * r
    return torch.cat(outs)[:m]


def _point_gather(vals: torch.Tensor, lay: ObsLayout) -> torch.Tensor:
    """Expand (m, ...) point values to the slot stream (per-tier broadcast;
    padding slots read point 0, whose weight there is zero)."""
    outs, p0 = [], 0
    for n, r in lay.tiers:
        if r:
            outs.append(vals[p0:p0 + n].repeat_interleave(r, dim=0))
        p0 += n
    if lay.pad:
        outs.append(vals[:1].expand((lay.pad,) + vals.shape[1:]))
    return torch.cat(outs)


def _assemble(state: BAState, obs: BAObservations, config: BAConfig, lay: ObsLayout):
    """Residuals -> (U, D, W, b_c, b_p, cost); the per-observation stage is
    kernel B4 on CUDA tensors."""
    V, M = state.C.shape[0], state.X.shape[0]
    cam = obs.cam.long()
    U, b_c, DtD, W, bp_o, cost = ba_blocks(
        obs.cam.contiguous(),
        state.C[cam].contiguous(),
        state.q[cam].contiguous(),
        _point_gather(state.X, lay).contiguous(),
        obs.uv_norm.contiguous(),
        obs.valid.to(state.X.dtype),
        V,
        float(config.huber_delta),
    )
    return U, _point_sum(DtD, M, lay), W, b_c, _point_sum(bp_o, M, lay), cost


def _solve_dense(U, Dinv, W, b_red, obs, pin, lam, lay: ObsLayout):
    """Exact Schur solve: coupling G (M, V, 7, 3) from per-tier one-hot
    products, the reduced (7V, 7V) system S = U + lam I - G D^-1 G^T,
    pinned cameras as identity rows, and a Cholesky solve."""
    M, V = Dinv.shape[0], U.shape[0]
    dt, dev = U.dtype, U.device
    Gs, off = [], 0
    for n, r in lay.tiers:
        if r == 0:
            Gs.append(torch.zeros((n, V, 7, 3), dtype=dt, device=dev))
            continue
        ohc = cam_onehot(obs.cam[off:off + n * r], V, dt).reshape(n, r, V)
        Gs.append(torch.einsum("ntv,ntic->nvic", ohc, W[off:off + n * r].reshape(n, r, 7, 3)))
        off += n * r
    G = torch.cat(Gs)[:M]
    GD = torch.einsum("mvic,mcd->mvid", G, Dinv).reshape(M, V * 7, 3)
    coupling = torch.einsum("mad,mbd->ab", GD, G.reshape(M, V * 7, 3))  # [v*7+i, w*7+j]
    eye7 = torch.eye(7, dtype=dt, device=dev)
    S = torch.block_diag(*(U + lam * eye7)) - coupling
    pin7 = pin.repeat_interleave(7)
    eye = torch.eye(V * 7, dtype=dt, device=dev)
    S = torch.where(pin7[:, None], eye, S)
    S = torch.where(pin7[None, :], torch.where(eye > 0, S, torch.zeros_like(S)), S)
    b = torch.where(pin7, torch.zeros_like(b_red.reshape(-1)), b_red.reshape(-1))
    return solve_psd(S, b).reshape(V, 7)


def _solve_pcg(U, Dinv, W, b_red, obs, pin, lam, config: BAConfig, lay: ObsLayout,
               cg_iters: list | None):
    """Matrix-free block-Jacobi PCG on the reduced camera system. One
    matvec: B5 expands x to the slots, a point reduction and D^-1 give y,
    B6 reduces W y back onto the cameras over the camera-major view; S is
    never formed. The preconditioner inverts the exact 7x7 diagonal blocks
    of S."""
    V, M = U.shape[0], Dinv.shape[0]
    dt = U.dtype
    eye7 = torch.eye(7, dtype=dt, device=U.device)
    U_hat = U + lam * eye7
    cam = obs.cam.contiguous()
    w21 = W.reshape(-1, 21)
    # exact diagonal blocks: sum over each camera's observations of
    # W_o Dinv_pt(o) W_o^T (at most one observation per (camera, point))
    WD = torch.einsum("oic,ocd->oid", W, _point_gather(Dinv, lay))
    S_diag = _cam_sum(torch.einsum("oid,ojd->oij", WD, W), obs.cam, V, lay)
    P = torch.where(pin[:, None, None], eye7, U_hat - S_diag)
    Pinv, _ = torch.linalg.inv_ex(P)
    zero = torch.zeros((), dtype=dt, device=U.device)

    def matvec(x):
        xz = torch.where(pin[:, None], zero, x)
        t = expand_cam(cam, w21, xz.contiguous())  # G^T x per slot
        y = torch.einsum("mcd,md->mc", Dinv, _point_sum(t, M, lay))  # D^-1 G^T x
        coup = reduce_cam(w21, _point_gather(y, lay).contiguous(), lay.cam_perm, lay.cam_mask, V)
        out = torch.einsum("vij,vj->vi", U_hat, xz) - coup
        return torch.where(pin[:, None], x, out)

    def precond(r):
        return torch.einsum("vij,vj->vi", Pinv, r)

    b = torch.where(pin[:, None], zero, b_red)
    return pcg_solve(matvec, b, config.pcg_iterations, precond=precond, cg_iters=cg_iters)


def _reduce_and_solve(U, D, W, b_c, b_p, state: BAState, obs, config: BAConfig, lam,
                      lay: ObsLayout, cg_iters: list | None):
    """Schur reduction + reduced camera solve + point back-substitution."""
    V = state.C.shape[0]
    dt = state.X.dtype
    Dinv = inv3x3(D + lam * torch.eye(3, dtype=dt, device=D.device)) \
        * state.pt_valid[:, None, None].to(dt)
    y = torch.einsum("mcd,md->mc", Dinv, b_p)
    contrib = torch.einsum("oic,oc->oi", W, _point_gather(y, lay))
    b_red = b_c - _cam_sum(contrib, obs.cam, V, lay)
    pin = ~state.cam_valid
    if config.fix_first_camera_gauge:
        pin = pin.clone()
        pin[0] = True
    if V >= config.pcg_fallback_cameras:
        dc = _solve_pcg(U, Dinv, W, b_red, obs, pin, lam, config, lay, cg_iters)
    else:
        b_red = torch.where(pin[:, None], torch.zeros_like(b_red), b_red)
        dc = _solve_dense(U, Dinv, W, b_red, obs, pin, lam, lay)
    t = torch.einsum("oic,oi->oc", W, dc[obs.cam.long()])
    dp = torch.einsum("mcd,md->mc", Dinv, b_p - _point_sum(t, D.shape[0], lay))
    return dc, dp


def _apply_step(state: BAState, dc, dp) -> BAState:
    cam_ok = state.cam_valid[:, None].to(state.C.dtype)
    pt_ok = state.pt_valid[:, None].to(state.X.dtype)
    return state._replace(
        C=state.C + dc[:, :3] * cam_ok,
        q=quat_normalize(state.q + dc[:, 3:] * cam_ok),
        X=state.X + dp * pt_ok,
    )


def total_reprojection_cost(state: BAState, obs: BAObservations, huber_delta: float = 0.0,
                            lay: ObsLayout | None = None) -> torch.Tensor:
    """Sum of (Huber-IRLS-weighted) squared normalised residuals over valid
    observations; with ``lay`` the stream is read in that layout, else by
    ``obs.point``."""
    cam = obs.cam.long()
    X = _point_gather(state.X, lay) if lay is not None else state.X[obs.point.long()]
    res, _, _ = batched_residual_jacobians(state.C[cam], state.q[cam], X, obs.uv_norm)
    w = huber_weights(res, huber_delta) * obs.valid.to(res.dtype)
    return ((res * w[:, None]) ** 2).sum()


def _layout(state: BAState, obs: BAObservations, config: BAConfig):
    """Canonicalise the stream once per BA call -> (obs, ObsLayout)."""
    V, M = state.C.shape[0], state.X.shape[0]
    if config.obs_layout == "tiered":
        if not config.tiers:
            raise ValueError("obs_layout='tiered' requires config.tiers")
        tiers = tuple(config.tiers)
        lay = ObsLayout(tiers=tiers, pad=obs.cam.shape[0] - sum(n * r for n, r in tiers))
    elif config.obs_layout == "ell" and not config.ell_tail:
        rows = config.ell_rows or V
        obs = _to_ell(obs, M, rows)
        lay = ObsLayout(tiers=((M, rows),))
    else:
        raise NotImplementedError(
            "the CSR layout and the hybrid-ELL tail serve only the sharded solve, "
            "which is not ported yet (ROADMAP A13)")
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
                          cg_iters: list | None = None):
    """``config.iterations`` LM iterations; returns (state, per-iteration
    costs (iterations,)). With ``config.adaptive`` rejected steps roll back
    and grow lambda, accepted ones shrink it (on device, no host sync).
    ``cg_iters``, when given, receives the PCG iteration count of each LM
    iteration that solved by PCG."""
    obs, lay = _layout(state, obs, config)
    lam = torch.tensor(config.damping, dtype=state.X.dtype, device=state.X.device)
    costs = []
    for _ in range(config.iterations):
        U, D, W, b_c, b_p, cost = _assemble(state, obs, config, lay)
        dc, dp = _reduce_and_solve(U, D, W, b_c, b_p, state, obs, config, lam, lay, cg_iters)
        cand = _apply_step(state, dc, dp)
        costs.append(cost)
        if not config.adaptive:
            state = cand
            continue
        accept = total_reprojection_cost(cand, obs, config.huber_delta, lay) < cost
        state = BAState(*(torch.where(accept, a, b) for a, b in zip(cand, state)))
        lam = torch.clamp(
            torch.where(accept, lam * config.damping_down, lam * config.damping_up),
            config.min_damping, config.max_damping,
        )
    return state, torch.stack(costs)
