"""Schur-complement Levenberg-Marquardt bundle adjustment, main-path subset
(port of ``structure_from_motion_tpu/ops/ba.py``).

Observations are packed once per call into the ELL layout (point m owns
``rows`` contiguous slots), so every point-axis reduction is a reshape-sum
and every point gather a broadcast. One LM iteration: block assembly
(kernel B4 on the card), Schur reduction onto the cameras, a dense Cholesky
solve of the (7V, 7V) reduced system, point back-substitution, and the
adaptive accept test on the same Huber objective the assembly charged. The
tiered/CSR/PCG/camera-ELL layouts of the JAX package are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_from_motion_tpu.config import BAConfig
from structure_from_motion_tpu_torch.ops.ba_cuda import ba_blocks, cam_onehot, huber_weights
from structure_from_motion_tpu_torch.ops.linalg import inv3x3, solve_psd
from structure_from_motion_tpu_torch.ops.reproj import batched_residual_jacobians
from structure_from_motion_tpu_torch.utils.rotations import quat_normalize

__all__ = [
    "BAObservations", "BAState", "huber_weights", "run_bundle_adjustment",
    "total_reprojection_cost",
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


def _point_sum(vals: torch.Tensor, m: int, rows: int) -> torch.Tensor:
    """Sum per-slot values into (m, ...) point bins (ELL reshape-sum)."""
    return vals.reshape((m, rows) + vals.shape[1:]).sum(1)


def _point_gather(vals: torch.Tensor, rows: int) -> torch.Tensor:
    """Expand (m, ...) point values to the ELL slot stream."""
    return vals.repeat_interleave(rows, dim=0)


def _cam_sum(vals: torch.Tensor, cam: torch.Tensor, n_views: int) -> torch.Tensor:
    """Sum per-slot values into (n_views, ...) camera bins (one-hot product)."""
    oh = cam_onehot(cam, n_views, vals.dtype)
    return (oh.T @ vals.reshape(vals.shape[0], -1)).reshape((n_views,) + vals.shape[1:])


def _assemble(state: BAState, obs: BAObservations, config: BAConfig, rows: int):
    """Residuals -> (U, D, W, b_c, b_p, cost); the per-observation stage is
    kernel B4 on CUDA tensors."""
    V, M = state.C.shape[0], state.X.shape[0]
    cam = obs.cam.long()
    U, b_c, DtD, W, bp_o, cost = ba_blocks(
        obs.cam.contiguous(),
        state.C[cam].contiguous(),
        state.q[cam].contiguous(),
        _point_gather(state.X, rows).contiguous(),
        obs.uv_norm.contiguous(),
        obs.valid.to(state.X.dtype),
        V,
        float(config.huber_delta),
    )
    return U, _point_sum(DtD, M, rows), W, b_c, _point_sum(bp_o, M, rows), cost


def _solve_dense(U, Dinv, W, b_red, obs, pin, lam, rows: int):
    """Exact Schur solve: coupling G (M, V, 7, 3) from the ELL slots, the
    reduced (7V, 7V) system S = U + lam I - G D^-1 G^T, pinned cameras as
    identity rows, and a Cholesky solve."""
    M, V = Dinv.shape[0], U.shape[0]
    dt, dev = U.dtype, U.device
    ohc = cam_onehot(obs.cam, V, dt).reshape(M, rows, V)
    G = torch.einsum("mtv,mtic->mvic", ohc, W.reshape(M, rows, 7, 3))
    GD = torch.einsum("mvic,mcd->mvid", G, Dinv).reshape(M, V * 7, 3)
    Gf = G.reshape(M, V * 7, 3)
    coupling = torch.einsum("mad,mbd->ab", GD, Gf)  # (7V, 7V), [v*7+i, w*7+j]
    eye7 = torch.eye(7, dtype=dt, device=dev)
    S = torch.block_diag(*(U + lam * eye7)) - coupling
    pin7 = pin.repeat_interleave(7)
    eye = torch.eye(V * 7, dtype=dt, device=dev)
    S = torch.where(pin7[:, None], eye, S)
    S = torch.where(pin7[None, :], torch.where(eye > 0, S, torch.zeros_like(S)), S)
    b = torch.where(pin7, torch.zeros_like(b_red.reshape(-1)), b_red.reshape(-1))
    return solve_psd(S, b).reshape(V, 7)


def _reduce_and_solve(U, D, W, b_c, b_p, state: BAState, obs, config: BAConfig, lam, rows):
    """Schur reduction + reduced camera solve + point back-substitution."""
    V = state.C.shape[0]
    dt = state.X.dtype
    Dinv = inv3x3(D + lam * torch.eye(3, dtype=dt, device=D.device)) \
        * state.pt_valid[:, None, None].to(dt)
    y = torch.einsum("mcd,md->mc", Dinv, b_p)
    contrib = torch.einsum("oic,oc->oi", W, _point_gather(y, rows))
    b_red = b_c - _cam_sum(contrib, obs.cam, V)
    pin = ~state.cam_valid
    if config.fix_first_camera_gauge:
        pin = pin.clone()
        pin[0] = True
    if V >= config.pcg_fallback_cameras:
        raise NotImplementedError("the port solves the reduced system densely only")
    b_red = torch.where(pin[:, None], torch.zeros_like(b_red), b_red)
    dc = _solve_dense(U, Dinv, W, b_red, obs, pin, lam, rows)
    t = torch.einsum("oic,oi->oc", W, dc[obs.cam.long()])
    dp = torch.einsum("mcd,md->mc", Dinv, b_p - _point_sum(t, D.shape[0], rows))
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
                            rows: int = 0) -> torch.Tensor:
    """Sum of (Huber-IRLS-weighted) squared normalised residuals over valid
    observations; ``rows`` > 0 reads ``obs`` as an ELL stream."""
    cam = obs.cam.long()
    X = _point_gather(state.X, rows) if rows else state.X[obs.point.long()]
    res, _, _ = batched_residual_jacobians(state.C[cam], state.q[cam], X, obs.uv_norm)
    w = huber_weights(res, huber_delta) * obs.valid.to(res.dtype)
    return ((res * w[:, None]) ** 2).sum()


def run_bundle_adjustment(state: BAState, obs: BAObservations, config: BAConfig):
    """``config.iterations`` LM iterations; returns (state, per-iteration
    costs (iterations,)). With ``config.adaptive`` rejected steps roll back
    and grow lambda, accepted ones shrink it (on device, no host sync)."""
    if config.obs_layout != "ell" or config.ell_tail or config.cam_rows:
        raise NotImplementedError("the port's BA covers the pure ELL layout")
    rows = config.ell_rows or state.C.shape[0]
    M = state.X.shape[0]
    obs = _to_ell(obs, M, rows)
    lam = torch.tensor(config.damping, dtype=state.X.dtype, device=state.X.device)
    costs = []
    for _ in range(config.iterations):
        U, D, W, b_c, b_p, cost = _assemble(state, obs, config, rows)
        dc, dp = _reduce_and_solve(U, D, W, b_c, b_p, state, obs, config, lam, rows)
        cand = _apply_step(state, dc, dp)
        costs.append(cost)
        if not config.adaptive:
            state = cand
            continue
        accept = total_reprojection_cost(cand, obs, config.huber_delta, rows) < cost
        state = BAState(*(torch.where(accept, a, b) for a, b in zip(cand, state)))
        lam = torch.clamp(
            torch.where(accept, lam * config.damping_down, lam * config.damping_up),
            config.min_damping, config.max_damping,
        )
    return state, torch.stack(costs)
