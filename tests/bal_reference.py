"""A plain self-calibrating bundle adjustment of BAL problems: the reference
of the port's global solve with the 10-wide camera block.

Plain float64 torch; imports neither JAX nor any module of the port. The
problem is BAL's (Agarwal et al., *Bundle Adjustment in the Large*, ECCV
2010): per camera an angle-axis rotation ``w``, a translation ``t``, a focal
length ``f`` and radial terms ``k1``, ``k2``; Snavely's projection ``P = R(w)
X + t``, ``p = -P / P_z``, ``xy = f (1 + k1 |p|^2 + k2 |p|^4) p``; squared
pixel residuals, no robust loss (:func:`snavely_project`, :func:`bal_cost`).

The LM runs on the same unknowns as the port, so that both walk the same
path: each camera as a centre ``C``, a unit quaternion ``q`` and ``(f, k1,
k2)``, with ``R(w) = diag(1, -1, -1) R(q)^T`` and ``C = -R(w)^T t``, the
rotation's derivative that of the quaternion's raw quadratic form, and a
step ``q + dq`` normalised. The residuals are Snavely's projection of those
unknowns, their Jacobians taken by autograd (not the port's closed forms).
The damping is Marquardt's, as Ceres' on BAL problems: ``lambda diag(A)``
added to every camera block and every point block ``A`` of ``J^T J``, the
diagonal clamped below at ``MIN_DIAGONAL`` (Ceres' ``min_lm_diagonal``);
the step is an exact Schur step: the reduced ``(10V, 10V)`` camera system,
formed over chunks of points so that it fits (each point's pairs of
observations scattered into their camera blocks; points seen by more than
``dense_from`` cameras through a dense product over every camera), is
factored by a dense Cholesky; the adaptive accept test and lambda rule are
the port's.

``precision="f64"`` is the reference; ``precision="tf32"`` its control:
float32 with each product's operands rounded to TF32 (10 mantissa bits),
as the card's tensor cores take them with ``allow_tf32`` on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FLIP = (1.0, -1.0, -1.0)
MIN_DIAGONAL = 1e-6


class Problem(NamedTuple):
    """A BAL problem as tensors, in BAL's convention."""

    cameras: torch.Tensor  # (V, 9) w, t, f, k1, k2
    points: torch.Tensor  # (M, 3)
    cam: torch.Tensor  # (O,) int64
    point: torch.Tensor  # (O,) int64
    xy: torch.Tensor  # (O, 2) pixels


def as_problem(cameras, points, cam, point, xy, device, dtype=torch.float64) -> Problem:
    t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a)).to(device, dt)  # noqa: E731
    return Problem(t(cameras), t(points), t(cam, torch.int64), t(point, torch.int64), t(xy))


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) angle-axis -> (..., 3, 3)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    k = w / torch.where(theta > 0, theta, torch.ones_like(theta))
    kx, ky, kz = k.unbind(-1)
    z = torch.zeros_like(kx)
    K = torch.stack([torch.stack([z, -kz, ky], -1), torch.stack([kz, z, -kx], -1),
                     torch.stack([-ky, kx, z], -1)], -2)
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    return torch.eye(3, dtype=w.dtype, device=w.device) + s * K + (1 - c) * (K @ K)


def snavely_project(cameras: torch.Tensor, points: torch.Tensor, cam, point) -> torch.Tensor:
    """BAL's projection of every observation on the raw parameters: (O, 2)."""
    c = cameras[cam]
    P = (rodrigues(c[:, :3]) @ points[point][..., None])[..., 0] + c[:, 3:6]
    p = -P[:, :2] / P[:, 2:3]
    r2 = (p * p).sum(-1)
    return (c[:, 6] * (1 + c[:, 7] * r2 + c[:, 8] * r2 * r2))[:, None] * p


def bal_cost(p: Problem) -> float:
    """Sum of squared pixel residuals on the raw parameters."""
    return float(((p.xy - snavely_project(p.cameras, p.points, p.cam, p.point)) ** 2).sum())


def _rot_raw(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) -> the rotation's quadratic form, not normalised."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ], -2)


def _quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> unit quaternions (w >= 0), largest pivot."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cand = torch.stack([
        torch.stack([1 + tr, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1]], -1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2], 1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                     m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                     1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2], m[..., 1, 2] + m[..., 2, 1]], -1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1], 1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1),
    ], -2)
    best = torch.stack([cand[..., i, i] for i in range(4)], -1).argmax(-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / q.norm(dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def to_unknowns(cameras: torch.Tensor):
    """BAL cameras -> the LM's unknowns (C, q, intr)."""
    flip = torch.tensor(FLIP, dtype=cameras.dtype, device=cameras.device)
    R = rodrigues(cameras[:, :3])
    C = -(R.transpose(-1, -2) @ cameras[:, 3:6, None])[..., 0]
    return C, _quat(R.transpose(-1, -2) * flip), cameras[:, 6:9].clone()


def to_cameras(C, q, intr) -> torch.Tensor:
    """The LM's unknowns -> BAL cameras (w, t, f, k1, k2)."""
    flip = torch.tensor(FLIP, dtype=C.dtype, device=C.device)
    R = _rot_raw(q / q.norm(dim=-1, keepdim=True)).transpose(-1, -2) * flip[:, None]
    t = -(R @ C[..., None])[..., 0]
    qb = _quat(R)
    s = qb[:, 1:].norm(dim=-1, keepdim=True)
    ang = 2 * torch.atan2(s, qb[:, :1])
    w = qb[:, 1:] * torch.where(s > 1e-12, ang / torch.where(s > 0, s, torch.ones_like(s)),
                                torch.full_like(s, 2.0))
    return torch.cat([w, t, intr], -1)


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


def _project(C, q, intr, X, ar: _Arith):
    """Snavely's projection of per-observation unknowns (q's raw form)."""
    flip = torch.tensor(FLIP, dtype=C.dtype, device=C.device)
    P = ar.ein("oji,oj->oi", _rot_raw(q), X - C) * flip  # D R(q)^T (X - C) = R(w) X + t
    p = -P[:, :2] / P[:, 2:3]
    r2 = (p * p).sum(-1)
    return (intr[:, 0] * (1 + intr[:, 1] * r2 + intr[:, 2] * r2 * r2))[:, None] * p


def _cost(C, q, intr, X, p: Problem, ar: _Arith) -> torch.Tensor:
    qn = q / q.norm(dim=-1, keepdim=True)
    uv = _project(C[p.cam], qn[p.cam], intr[p.cam], X[p.point], ar)
    return ((p.xy - uv) ** 2).sum()


def _jacobians(C, q, intr, X, p: Problem, ar: _Arith):
    """Residuals (O, 2) and the projection's Jacobians (O, 2, 10) in [C, q,
    f, k1, k2] and (O, 2, 3) in X, by autograd (q's raw form at the unit
    quaternion; the derivative in the working precision, the residuals in
    the solve's)."""
    qn = q / q.norm(dim=-1, keepdim=True)
    ins = [t.detach().clone().requires_grad_(True)
           for t in (C[p.cam], qn[p.cam], intr[p.cam], X[p.point])]
    with torch.enable_grad():
        uv = _project(*ins, _Arith("f64"))
        rows = [torch.autograd.grad(uv[:, k].sum(), ins, retain_graph=k == 0) for k in range(2)]
    J_cam = torch.stack([torch.cat(g[:3], -1) for g in rows], 1)
    J_pt = torch.stack([g[3] for g in rows], 1)
    if ar.tf32:
        uv = _project(*(t.detach() for t in ins), ar)
    return p.xy - uv.detach(), J_cam, J_pt


def _damped(A: torch.Tensor, lam: float) -> torch.Tensor:
    """Blocks ``A`` (..., n, n) plus ``lam diag(A)``, the diagonal clamped
    below at ``MIN_DIAGONAL``."""
    return A + lam * torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1).clamp_min(MIN_DIAGONAL))


def _reduced_system(W, Dinv, U, lam, p: Problem, V: int, M: int, ar: _Arith,
                    dense_from: int, pair_budget: int):
    """S = blockdiag(U + lam diag(U)) - sum over points of W_a D^-1 W_b^T placed
    at (cam_a, cam_b): (10V, 10V), built a chunk of points at a time."""
    dt, dev = W.dtype, W.device
    S = torch.zeros((V * 10, V * 10), dtype=dt, device=dev)
    count = torch.bincount(p.point, minlength=M)
    by_pt = torch.argsort(p.point, stable=True)
    start = torch.cumsum(count, 0) - count
    order = torch.argsort(count, descending=True, stable=True)
    counts = count[order].cpu().numpy()
    i = 0
    while i < M and counts[i] > 0:
        L = int(counts[i])
        if L > dense_from:  # few long tracks: one dense product over every camera
            n = max(1, min(M - i, (1 << 25) // (V * 30)))
            pts = order[i:i + n]
            n = pts.shape[0]
            idx = start[pts][:, None] + torch.arange(L, device=dev)
            ok = torch.arange(L, device=dev) < count[pts][:, None]
            o = by_pt[idx.clamp(max=by_pt.shape[0] - 1)]
            G = torch.zeros((n, V, 10, 3), dtype=dt, device=dev)
            rows = torch.arange(n, device=dev)[:, None].expand(n, L)
            G.index_put_((rows[ok], p.cam[o][ok]), W[o][ok], accumulate=True)
            GD = ar.ein("nvic,ncd->nvid", G, Dinv[pts]).reshape(n, V * 10, 3)
            S -= ar.ein("nad,nbd->ab", GD, G.reshape(n, V * 10, 3))
        else:
            n = max(1, pair_budget // (L * L))
            pts = order[i:i + n]
            n = pts.shape[0]
            idx = start[pts][:, None] + torch.arange(L, device=dev)
            ok = torch.arange(L, device=dev) < count[pts][:, None]
            o = by_pt[idx.clamp(max=by_pt.shape[0] - 1)]
            Wt = W[o] * ok[..., None, None].to(dt)  # (n, L, 10, 3)
            Y = ar.ein("nlic,ncd->nlid", Wt, Dinv[pts])
            blk = ar.ein("nlic,nmjc->nlmij", Y, Wt)  # (n, L, L, 10, 10)
            ca, cb = p.cam[o][:, :, None], p.cam[o][:, None, :]
            row = ((ca * 10)[..., None] + torch.arange(10, device=dev)) * V + cb[..., None]
            S.view(V * 10 * V, 10).index_add_(0, row.reshape(-1), -blk.reshape(-1, 10))
        i += n
    diag = _damped(U, lam)
    v = torch.arange(V, device=dev)
    S.view(V, 10, V, 10)[v, :, v, :] += diag
    return S


def solve(p: Problem, iterations: int, ba: dict, precision: str = "f64", dense_from: int = 64,
          pair_budget: int = 1 << 21) -> dict:
    """``iterations`` LM iterations from the problem's cameras and points ->
    ``costs`` (the cost at the start of each iteration), ``cameras`` (V, 9)
    and ``points`` (M, 3) in BAL's convention, ``intr`` (V, 3), numpy
    float64."""
    ar = _Arith(precision)
    dt, dev = ar.dtype, p.cameras.device
    p = Problem(*(t.to(dt) if t.is_floating_point() else t for t in p))
    C, q, intr = (t.to(dt) for t in to_unknowns(p.cameras.double()))
    X = p.points.clone()
    V, M = C.shape[0], X.shape[0]
    lam = float(ba["damping"])
    costs = []
    for _ in range(iterations):
        res, Jc, Jp = _jacobians(C, q, intr, X, p, ar)
        cur = (res ** 2).sum()
        costs.append(float(cur))
        U = torch.zeros((V, 10, 10), dtype=dt, device=dev).index_add_(
            0, p.cam, ar.ein("oki,okj->oij", Jc, Jc))
        bc = torch.zeros((V, 10), dtype=dt, device=dev).index_add_(
            0, p.cam, ar.ein("oki,ok->oi", Jc, res))
        D = torch.zeros((M, 3, 3), dtype=dt, device=dev).index_add_(
            0, p.point, ar.ein("oki,okj->oij", Jp, Jp))
        bp = torch.zeros((M, 3), dtype=dt, device=dev).index_add_(
            0, p.point, ar.ein("oki,ok->oi", Jp, res))
        W = ar.ein("oki,okj->oij", Jc, Jp)  # (O, 10, 3)
        del Jc
        Dinv = torch.linalg.inv(_damped(D, lam))
        y = ar.ein("mcd,md->mc", Dinv, bp)
        b_red = bc - torch.zeros_like(bc).index_add_(0, p.cam, ar.ein("oic,oc->oi", W, y[p.point]))
        S = _reduced_system(W, Dinv, U, lam, p, V, M, ar, dense_from, pair_budget)
        L, bad = torch.linalg.cholesky_ex(S)
        if int(bad):  # rounding left S indefinite: an LU solve still gives a step
            dc = torch.linalg.solve(S, b_red.reshape(-1, 1)).reshape(V, 10)
        else:
            dc = torch.cholesky_solve(b_red.reshape(-1, 1), L).reshape(V, 10)
        del S, L
        t = ar.ein("oic,oi->oc", W, dc[p.cam])
        dp = ar.ein("mcd,md->mc", Dinv, bp - torch.zeros_like(bp).index_add_(0, p.point, t))
        Cn, intr_n, Xn = C + dc[:, :3], intr + dc[:, 7:], X + dp
        qn = q + dc[:, 3:7]
        qn = qn / qn.norm(dim=-1, keepdim=True)
        if _cost(Cn, qn, intr_n, Xn, p, ar) < cur:
            C, q, intr, X = Cn, qn, intr_n, Xn
            lam = min(max(lam * float(ba["damping_down"]), float(ba["min_damping"])),
                      float(ba["max_damping"]))
        else:
            lam = min(max(lam * float(ba["damping_up"]), float(ba["min_damping"])),
                      float(ba["max_damping"]))
    cams = to_cameras(C.double(), q.double(), intr.double())
    return dict(costs=np.array(costs), cameras=cams.cpu().numpy(),
                points=X.double().cpu().numpy(), intr=intr.double().cpu().numpy())
