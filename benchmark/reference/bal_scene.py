"""A BAL problem drawn from a seed at a photo collection's counts and shape:
the data of the self-calibrating solve cell.

Cameras stand around a plaza and look inward; every point lies in the
plaza's middle, so each camera sees each point in front of it and inside
its 1024x768 frame (checked: a draw that breaks it raises). Track lengths
follow a power law truncated to [2, V] whose exponent is fitted to the mean
``n_obs / n_points``, then adjusted by single steps to the exact total; a
track's cameras are drawn without replacement by weight (log-normal
weights: a few popular views see most points). Cameras carry Snavely's
intrinsics (``f``, ``k1``, ``k2``); observations are their projections
plus Gaussian pixel noise. The start is BAL's "-pre" kind: every rotation
turned by a fixed angle about a random axis, every centre and point moved
a fixed share of the scene's extent in a random direction, ``f`` off by a
fixed share either way, ``k1 = k2 = 0``.

Plain torch in float64 on whatever device is given, from one
``torch.Generator`` seeded with the seed; imports nothing of the port (the
rotations are ``bal_ba``'s).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import bal_ba

FRAME = (1024, 768)  # width, height in pixels (principal point at the centre)
KEYS_A_CHUNK = 1 << 25  # (points x cameras) Gumbel keys drawn at once


def _angle_axis(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> angle-axis vectors, through the unit quaternion
    (largest pivot, w >= 0): sound up to an angle of pi."""
    q = bal_ba._quat(R)
    s = q[..., 1:].norm(dim=-1, keepdim=True)
    angle = 2 * torch.atan2(s, q[..., :1])
    return q[..., 1:] * torch.where(s > 1e-12, angle / torch.where(s > 0, s, torch.ones_like(s)),
                                    torch.full_like(s, 2.0))


def _unit(g: torch.Generator, n: int, dev) -> torch.Tensor:
    v = torch.randn((n, 3), generator=g, dtype=torch.float64, device=dev)
    return v / v.norm(dim=-1, keepdim=True)


def power_law_exponent(mean: float, hi: int, lo: int = 2) -> float:
    """The exponent a of p(L) ~ L^-a on the integers [lo, hi] whose mean is
    ``mean`` (bisection)."""
    L = torch.arange(lo, hi + 1, dtype=torch.float64)
    a0, a1 = 0.0, 8.0
    for _ in range(100):
        a = 0.5 * (a0 + a1)
        p = L ** -a
        if float((p * L).sum() / p.sum()) > mean:
            a0 = a
        else:
            a1 = a
    return 0.5 * (a0 + a1)


def track_lengths(g: torch.Generator, n_points: int, n_obs: int, hi: int, dev) -> torch.Tensor:
    """(M,) int64 lengths on [2, hi] from the fitted power law, summing to
    ``n_obs`` exactly (single steps up or down on random tracks)."""
    L = torch.arange(2, hi + 1, dtype=torch.float64, device=dev)
    p = L ** -power_law_exponent(n_obs / n_points, hi)
    cdf = torch.cumsum(p / p.sum(), 0)
    u = torch.rand(n_points, generator=g, dtype=torch.float64, device=dev)
    lengths = torch.searchsorted(cdf, u).clamp(max=hi - 2) + 2
    while True:
        d = n_obs - int(lengths.sum())
        if d == 0:
            return lengths
        ok = lengths < hi if d > 0 else lengths > 2
        idx = torch.nonzero(ok)[:, 0]
        pick = idx[torch.randperm(idx.shape[0], generator=g, device=dev)[:abs(d)]]
        lengths[pick] += 1 if d > 0 else -1


def draw(seed: int, n_cams: int, n_points: int, n_obs: int, a: dict, device) -> dict:
    """The problem of ``seed`` with the settings ``a`` (the configuration's
    ``assumed``): ``cameras`` (V, 9) and ``points`` (M, 3), the "-pre"
    start; ``cam`` and ``point`` (O,) int32, observations grouped by point;
    ``xy`` (O, 2) pixels; ``true_cameras``, ``true_points``; float64 on
    ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (2 ** 63))
    f64 = dict(dtype=torch.float64, device=dev)
    rand = lambda *s: torch.rand(s, generator=g, **f64)  # noqa: E731
    randn = lambda *s: torch.randn(s, generator=g, **f64)  # noqa: E731
    V, M = n_cams, n_points

    # the plaza: points in a disc of radius r and height [0, h]; cameras on a
    # ring at distances [d0, d1], looking at the middle (jittered)
    r, h = a["plaza_radius"], a["plaza_height"]
    ang, rad = 2 * math.pi * rand(M), r * torch.sqrt(rand(M))
    X = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang), h * rand(M)], -1)
    phi = 2 * math.pi * rand(V)
    dist = a["camera_distance"][0] + (a["camera_distance"][1] - a["camera_distance"][0]) * rand(V)
    C = torch.stack([dist * torch.cos(phi), dist * torch.sin(phi),
                     a["camera_height"][0] + (a["camera_height"][1] - a["camera_height"][0])
                     * rand(V)], -1)
    target = torch.cat([a["aim_jitter"] * randn(V, 2), (h / 2 + a["aim_jitter"] * randn(V))[:, None]],
                       -1)
    fwd = target - C
    fwd = fwd / fwd.norm(dim=-1, keepdim=True)
    zc = -fwd  # BAL's camera looks down its -z axis
    up = torch.tensor([0.0, 0.0, 1.0], **f64).expand(V, 3)
    xc = torch.linalg.cross(up, zc)
    xc = xc / xc.norm(dim=-1, keepdim=True)
    yc = torch.linalg.cross(zc, xc)
    R = torch.stack([xc, yc, zc], -2)  # rows: the camera's axes in the world
    t = -(R @ C[..., None])[..., 0]
    f = a["focal"] * (1 + a["focal_spread"] * (2 * rand(V) - 1))
    k1, k2 = a["k1_sigma"] * randn(V), a["k2_sigma"] * randn(V)
    cams = torch.cat([_angle_axis(R), t, f[:, None], k1[:, None], k2[:, None]], -1)

    # tracks: lengths, then each track's cameras by weight without
    # replacement (Gumbel top-k), the longest tracks first
    lengths = track_lengths(g, M, n_obs, V, dev)
    logw = a["camera_weight_sigma"] * randn(V)
    order = torch.argsort(lengths, descending=True, stable=True)
    cam_rows, pt_rows = [], []
    i = 0
    while i < M:
        Lmax = int(lengths[order[i]])
        n = max(1, min(M - i, KEYS_A_CHUNK // V))
        pts = order[i:i + n]
        n = pts.shape[0]
        gum = -torch.log(-torch.log(rand(n, V).clamp_min(1e-300)))
        top = torch.topk(logw + gum, Lmax, dim=1).indices
        keep = torch.arange(Lmax, device=dev) < lengths[pts][:, None]
        cam_rows.append(top[keep])
        pt_rows.append(pts[:, None].expand(n, Lmax)[keep])
        i += n
    cam, point = torch.cat(cam_rows), torch.cat(pt_rows)

    # projections (Snavely's model) and the frame check
    P = (bal_ba.rodrigues(cams[cam, :3]) @ X[point][..., None])[..., 0] + cams[cam, 3:6]
    p = -P[:, :2] / P[:, 2:3]
    r2 = (p * p).sum(-1)
    c = cams[cam]
    xy = (c[:, 6] * (1 + c[:, 7] * r2 + c[:, 8] * r2 * r2))[:, None] * p
    half = torch.tensor([FRAME[0] / 2, FRAME[1] / 2], **f64)
    if not (bool((P[:, 2] < 0).all()) and bool((xy.abs() < half).all())):
        raise ValueError("a drawn observation lies behind its camera or outside its frame")
    xy = xy + a["noise_px"] * randn(cam.shape[0], 2)

    # the "-pre" start
    extent = 2.0 * r
    turn = math.radians(a["pre_rotation_deg"]) * _unit(g, V, dev)
    R0 = bal_ba.rodrigues(turn) @ R
    C0 = C + a["pre_shift_share"] * extent * _unit(g, V, dev)
    X0 = X + a["pre_shift_share"] * extent * _unit(g, M, dev)
    sign = torch.where(rand(V) < 0.5, -1.0, 1.0)
    pre = torch.cat([_angle_axis(R0), -(R0 @ C0[..., None])[..., 0],
                     (f * (1 + a["pre_focal_share"] * sign))[:, None],
                     torch.zeros((V, 2), **f64)], -1)
    return dict(cameras=pre, points=X0, cam=cam.to(torch.int32), point=point.to(torch.int32),
                xy=xy, true_cameras=cams, true_points=X)
