"""A plain whole-trajectory bundle adjustment: the reference of the global
solve.

From a checkpoint's raw arrays (the engine's npz layout: the live window's
``cam_C``, ``cam_q``, ``K``, ``points``, ``pt_valid``, ``pt_gid`` and
observation store, and the ``__archive_*`` records of the evicted views) it
builds the problem the global solve states: every camera, archived then
live; every global point id seen at least twice, seeded from its last
eviction and then from the live map; each pixel normalised by its own
camera's K. Then Levenberg-Marquardt on the Huber-weighted squared
normalised residuals (sqrt-IRLS weights), cameras as [C (3), q (4)] with
the quadratic rotation form's Jacobian, lambda I added to every block,
an exact Schur solve by a dense Cholesky factorisation of the (7V, 7V)
reduced system, and the adaptive accept test.

``precision="f64"`` is the reference. ``precision="tf32"`` is its control:
float32 tensors with every product's operands rounded to TF32 (10 mantissa
bits, accumulation in float32), as the card's tensor cores take them when
``allow_tf32`` is on. Imports nothing of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Problem(NamedTuple):
    C: torch.Tensor  # (V, 3)
    q: torch.Tensor  # (V, 4) (w, x, y, z)
    X: torch.Tensor  # (M, 3)
    cam: torch.Tensor  # (O,) int64
    pt: torch.Tensor  # (O,) int64
    uv: torch.Tensor  # (O, 2) normalised coordinates


def assemble(data: dict, min_obs: int = 2) -> dict:
    """The global problem of a checkpoint, as float64 numpy arrays:
    ``C``, ``q``, ``X``, ``cam``, ``pt``, ``uv`` (normalised), ``n_live``."""
    frame = int(data["__frame"])
    V = data["kp_xy"].shape[0]
    n_live = min(frame, V)
    K = np.asarray(data["K"], np.float64)
    K = np.broadcast_to(K, (V, 3, 3)) if K.ndim == 2 else K
    C, q, Ks = data["cam_C"][:n_live], data["cam_q"][:n_live], K[:n_live]
    has_arc = "__archive_C" in data and len(data["__archive_C"])
    cams, gids, uvs = [], [], []
    if has_arc:
        av = np.asarray(data["__archive_valid"], bool)
        A = av.shape[0]
        C = np.concatenate([data["__archive_C"], C])
        q = np.concatenate([data["__archive_q"], q])
        Ks = np.concatenate([data["__archive_K"], Ks])
        cams.append(np.nonzero(av)[0])
        gids.append(data["__archive_gid"][av])
        uvs.append(data["__archive_uv"][av])
    else:
        A = 0
    ov = np.asarray(data["obs_valid"], bool)
    cams.append(data["obs_cam"][ov].astype(np.int64) + A)
    gids.append(data["pt_gid"][data["obs_pt"][ov]])
    uvs.append(data["obs_uv"][ov])
    cam = np.concatenate(cams).astype(np.int64)
    gid = np.concatenate(gids).astype(np.int64)
    uv = np.concatenate(uvs).astype(np.float64)
    ids, counts = np.unique(gid[gid >= 0], return_counts=True)
    keep_ids = ids[counts >= min_obs]
    pos = {g: i for i, g in enumerate(keep_ids.tolist())}
    X = np.zeros((len(keep_ids), 3))
    if has_arc:  # eviction order: a later eviction's position wins
        for rec in range(A):
            v = av[rec]
            for g, x in zip(data["__archive_gid"][rec][v], data["__archive_X"][rec][v]):
                if g in pos:
                    X[pos[g]] = x
    live = np.asarray(data["pt_valid"], bool)
    for g, x in zip(data["pt_gid"][live], data["points"][live]):
        if g in pos:
            X[pos[g]] = x
    sel = np.array([g in pos for g in gid.tolist()], bool)
    cam, uv = cam[sel], uv[sel]
    pt = np.array([pos[g] for g in gid[sel].tolist()], np.int64)
    Kinv = np.linalg.inv(Ks.astype(np.float64))[cam]
    uvn = np.einsum("oij,oj->oi", Kinv, np.concatenate([uv, np.ones((len(uv), 1))], 1))[:, :2]
    return dict(C=np.asarray(C, np.float64), q=np.asarray(q, np.float64), X=X, cam=cam, pt=pt,
                uv=uvn, n_live=n_live)


def to_problem(arrays: dict, device, dtype) -> Problem:
    t = lambda k, dt=dtype: torch.as_tensor(arrays[k]).to(device, dt)  # noqa: E731
    return Problem(t("C"), t("q"), t("X"), t("cam", torch.int64), t("pt", torch.int64), t("uv"))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class _Arith:
    """Products in the solve's precision: exact float64, or TF32 operands."""

    def __init__(self, precision: str):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def ein(self, eq: str, *ops):
        if self.tf32:
            ops = [_tf32(o) for o in ops]
        return torch.einsum(eq, *ops)


def _rot_raw(q: torch.Tensor) -> torch.Tensor:
    """(O, 4) -> (O, 3, 3): the rotation's quadratic form, not normalised."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ], -2)


def _residuals(C, q, X, p: Problem, ar: _Arith):
    """(O, 2) residuals (measured - projected) with the (O, 3) camera-frame
    points."""
    R = _rot_raw(q[p.cam] / q[p.cam].norm(dim=-1, keepdim=True))
    x = ar.ein("oji,oj->oi", R, X[p.pt] - C[p.cam])
    return p.uv - x[:, :2] / x[:, 2:3], x


def _jacobians(C, q, X, p: Problem, ar: _Arith):
    """Residuals and the projection's Jacobians: (O, 2, 7) in [C, q] and
    (O, 2, 3) in X; the rotation's derivative is that of the quadratic form
    at the unit quaternion (autograd, one pass a camera-frame axis)."""
    qo = (q[p.cam] / q[p.cam].norm(dim=-1, keepdim=True)).detach().requires_grad_(True)
    d = (X[p.pt] - C[p.cam]).detach()
    R = _rot_raw(qo)
    with torch.enable_grad():
        x = torch.einsum("oji,oj->oi", R, d)
        dxdq = torch.stack([torch.autograd.grad(x[:, k].sum(), qo, retain_graph=k < 2)[0]
                            for k in range(3)], 1)  # (O, 3, 4)
    R = R.detach()
    x = ar.ein("oji,oj->oi", R, d)
    z = x[:, 2]
    u, v = x[:, 0] / z, x[:, 1] / z
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    dpdx = torch.stack([torch.stack([one, zero, -u], -1), torch.stack([zero, one, -v], -1)],
                       -2) / z[:, None, None]
    dpdX = ar.ein("oik,ojk->oij", dpdx, R)  # d x / d X = R^T
    dpdq = ar.ein("oik,okl->oil", dpdx, dxdq)
    res = p.uv - torch.stack([u, v], -1)
    return res, torch.cat([-dpdX, dpdq], -1), dpdX


def _weights(res: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt-IRLS Huber weights (1 with ``delta`` <= 0)."""
    if delta <= 0:
        return torch.ones_like(res[:, 0])
    n = res.norm(dim=-1)
    return torch.sqrt(torch.where(n <= delta, torch.ones_like(n), delta / n.clamp_min(1e-12)))


def cost(C, q, X, p: Problem, delta: float, ar: _Arith) -> torch.Tensor:
    res, _ = _residuals(C, q, X, p, ar)
    return ((res * _weights(res, delta)[:, None]) ** 2).sum()


def solve(p: Problem, iterations: int, ba: dict, precision: str = "f64") -> dict:
    """``iterations`` LM iterations -> ``costs`` (the cost at the start of
    each iteration), ``C``, ``q``, ``X`` (numpy float64)."""
    ar = _Arith(precision)
    dt, dev = ar.dtype, p.C.device
    p = Problem(*(t.to(dt) if t.is_floating_point() else t for t in p))
    C, q, X = p.C.clone(), p.q.clone(), p.X.clone()
    V, M = C.shape[0], X.shape[0]
    delta = float(ba["huber_delta"])
    lam = float(ba["damping"])
    eye7, eye3 = torch.eye(7, dtype=dt, device=dev), torch.eye(3, dtype=dt, device=dev)
    costs = []
    for _ in range(iterations):
        res, Jc, Jp = _jacobians(C, q, X, p, ar)
        w = _weights(res, delta)
        res, Jc, Jp = res * w[:, None], Jc * w[:, None, None], Jp * w[:, None, None]
        cur = (res ** 2).sum()
        costs.append(float(cur))
        U = torch.zeros((V, 7, 7), dtype=dt, device=dev).index_add_(
            0, p.cam, ar.ein("oki,okj->oij", Jc, Jc))
        bc = torch.zeros((V, 7), dtype=dt, device=dev).index_add_(
            0, p.cam, ar.ein("oki,ok->oi", Jc, res))
        D = torch.zeros((M, 3, 3), dtype=dt, device=dev).index_add_(
            0, p.pt, ar.ein("oki,okj->oij", Jp, Jp))
        bp = torch.zeros((M, 3), dtype=dt, device=dev).index_add_(
            0, p.pt, ar.ein("oki,ok->oi", Jp, res))
        W = ar.ein("oki,okj->oij", Jc, Jp)  # (O, 7, 3)
        Dinv = torch.linalg.inv(D + lam * eye3)
        y = ar.ein("mcd,md->mc", Dinv, bp)
        b_red = bc - torch.zeros_like(bc).index_add_(0, p.cam, ar.ein("oic,oc->oi", W, y[p.pt]))
        G = torch.zeros((M, V, 7, 3), dtype=dt, device=dev)
        G.index_put_((p.pt, p.cam), W, accumulate=True)
        GD = ar.ein("mvic,mcd->mvid", G, Dinv).reshape(M, 7 * V, 3)
        S = -ar.ein("mad,mbd->ab", GD, G.reshape(M, 7 * V, 3))
        del G, GD
        blocks = (U + lam * eye7).reshape(V, 7, 7)
        idx = torch.arange(V, device=dev)
        S.view(V, 7, V, 7)[idx, :, idx, :] += blocks
        L, bad = torch.linalg.cholesky_ex(S)
        if int(bad):  # rounding left S indefinite: an LU solve still gives a step
            dc = torch.linalg.solve(S, b_red.reshape(-1, 1)).reshape(V, 7)
        else:
            dc = torch.cholesky_solve(b_red.reshape(-1, 1), L).reshape(V, 7)
        t = ar.ein("oic,oi->oc", W, dc[p.cam])
        dp = ar.ein("mcd,md->mc", Dinv, bp - torch.zeros_like(bp).index_add_(0, p.pt, t))
        Cn, Xn = C + dc[:, :3], X + dp
        qn = q + dc[:, 3:]
        qn = qn / qn.norm(dim=-1, keepdim=True)
        if cost(Cn, qn, Xn, p, delta, ar) < cur:
            C, q, X = Cn, qn, Xn
            lam = min(max(lam * float(ba["damping_down"]), float(ba["min_damping"])),
                      float(ba["max_damping"]))
        else:
            lam = min(max(lam * float(ba["damping_up"]), float(ba["min_damping"])),
                      float(ba["max_damping"]))
    return dict(costs=np.array(costs), C=C.double().cpu().numpy(), q=q.double().cpu().numpy(),
                X=X.double().cpu().numpy())
