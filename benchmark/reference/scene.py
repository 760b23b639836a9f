"""The rendered scene of the benchmark's traffic, with its exact camera path.

A frozen copy of the port's ``io/synthetic.py`` (a textured room corner with
three boxes and a slab, cast by rays through a pinhole camera on a smooth
Lissajous path), rewritten so that the frames render with plain torch on
whatever device is given: on the card, a ring of 200 frames of 960x1280
takes well under a second of set-up, where the numpy original takes minutes.
The path and the intrinsics are the original's, in float64, so the poses
are exact and independent of the texture seed.

Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

TEXTURE_SIZE = 512
PIXELS_A_BATCH = 1 << 23  # frames cast together, by their pixels

# each plane: (normal, offset, u-axis, v-axis, (u_lo, u_hi, v_lo, v_hi)),
# the point-on-plane test being normal . X == offset; the nearest hit wins
PLANES = (
    ((0.0, 0, 1), 14.0, (1.0, 0, 0), (0.0, 1, 0), (-9.0, 9.0, -7.0, 7.0)),
    ((1.0, 0, 0), -6.0, (0.0, 0, 1), (0.0, 1, 0), (2.0, 14.0, -7.0, 7.0)),
    ((0.0, 1, 0), 3.0, (1.0, 0, 0), (0.0, 0, 1), (-9.0, 9.0, 2.0, 14.0)),
    ((0.0, 0, 1), 8.0, (1.0, 0, 0), (0.0, 1, 0), (-3.0, -0.5, 0.5, 3.0)),
    ((0.0, 1, 0), 0.5, (1.0, 0, 0), (0.0, 0, 1), (-3.0, -0.5, 8.0, 10.0)),
    ((1.0, 0, 0), -0.5, (0.0, 0, 1), (0.0, 1, 0), (8.0, 10.0, 0.5, 3.0)),
    ((0.0, 0, 1), 10.5, (1.0, 0, 0), (0.0, 1, 0), (2.0, 4.5, -1.5, 3.0)),
    ((0.0, 1, 0), -1.5, (1.0, 0, 0), (0.0, 0, 1), (2.0, 4.5, 10.5, 12.5)),
    ((1.0, 0, 0), 2.0, (0.0, 0, 1), (0.0, 1, 0), (10.5, 12.5, -1.5, 3.0)),
    ((0.0, 1, 0), -2.5, (1.0, 0, 0), (0.0, 0, 1), (-2.0, 1.5, 9.0, 11.0)),
    ((0.0, 0, 1), 9.0, (1.0, 0, 0), (0.0, 1, 0), (-2.0, 1.5, -2.5, -2.0)),
)


def intrinsics(size) -> np.ndarray:
    """(3, 3) float64 pinhole matrix of a (H, W) frame: focal 0.9 W, centred."""
    H, W = size
    f = 0.9 * W
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float64)


def _look_at(C: np.ndarray, target: np.ndarray, roll: float) -> np.ndarray:
    """Camera-to-world rotation whose +z axis looks from ``C`` at ``target``
    (x right, y down: world +y is down)."""
    z = target - C
    z = z / np.linalg.norm(z)
    up = np.array([np.sin(roll), np.cos(roll), 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def path_poses(n_frames: int, size, loops: float, path_scale: float = 1.0):
    """(K, C (F, 3), R (F, 3, 3)), float64: ``n_frames`` poses spread evenly
    over ``loops`` turns of the path, camera-to-world, a world point X
    projecting to K R^T (X - C)."""
    K = intrinsics(size)
    t = np.linspace(0.0, loops * 2 * np.pi, n_frames, endpoint=False)
    C = np.stack([2.4 * path_scale * np.sin(t), 0.9 * path_scale * np.sin(2 * t + 0.9),
                  1.8 * path_scale * np.sin(0.5 * t + 0.3)], axis=1)
    target = np.array([1.0, -0.5, 12.0])
    R = np.stack([_look_at(C[i], target, 0.08 * np.sin(3 * t[i])) for i in range(n_frames)])
    return K, C, R


def texture(seed: int) -> np.ndarray:
    """(512, 512) float32 texture in [0, 1]: three octaves of bilinearly
    upsampled uniform noise, as the original draws it from ``seed``."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((TEXTURE_SIZE, TEXTURE_SIZE), np.float32)
    for octave, weight in ((4, 0.45), (16, 0.3), (64, 0.25)):
        small = rng.uniform(0, 1, (octave, octave)).astype(np.float32)
        idx = np.linspace(0, octave - 1, TEXTURE_SIZE, dtype=np.float32)
        i0 = np.clip(idx.astype(np.int32), 0, octave - 2)
        f = idx - i0
        row = small[i0] * (1 - f)[:, None] + small[i0 + 1] * f[:, None]
        tex += weight * (row[:, i0] * (1 - f)[None, :] + row[:, i0 + 1] * f[None, :])
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return tex


def render(n_frames: int, size, seed: int, loops: float, device="cpu") -> torch.Tensor:
    """(F, H, W) uint8 frames of the path on ``device``; the textures come
    from ``seed`` (plane i's from ``seed + 7 i``, as in the original)."""
    H, W = size
    K, C_all, R_all = path_poses(n_frames, size, loops)
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    texs = torch.stack([torch.as_tensor(texture(seed + 7 * i)) for i in range(len(PLANES))])
    texs = texs.to(dev).reshape(len(PLANES), -1)
    S = TEXTURE_SIZE
    u, v = torch.meshgrid(torch.arange(W, **f64) + 0.5, torch.arange(H, **f64) + 0.5,
                          indexing="xy")
    rays = torch.stack([u, v, torch.ones_like(u)], -1) @ torch.as_tensor(np.linalg.inv(K).T, **f64)
    planes = [tuple(torch.as_tensor(np.asarray(a, np.float64), **f64) for a in (n, au, av))
              + (off, box) for n, off, au, av, box in PLANES]
    out = torch.empty((n_frames, H, W), dtype=torch.uint8, device=dev)
    step = max(1, PIXELS_A_BATCH // (H * W))
    for f0 in range(0, n_frames, step):
        f1 = min(f0 + step, n_frames)
        R = torch.as_tensor(R_all[f0:f1], **f64)
        d = torch.einsum("hwj,fij->fhwi", rays, R)  # world-frame ray directions
        C = torch.as_tensor(C_all[f0:f1], **f64)[:, None, None, :]
        best = torch.full(d.shape[:-1], float("inf"), **f64)
        shade = torch.full(d.shape[:-1], 0.5, dtype=torch.float32, device=dev)
        for i, (n, au, av, off, (ulo, uhi, vlo, vhi)) in enumerate(planes):
            denom = d @ n
            ti = (off - (C @ n)) / denom
            P = C + ti[..., None] * d
            pu, pv = P @ au, P @ av
            hit = ((ti > 0.1) & (denom.abs() > 1e-9) & (ti < best)
                   & (pu >= ulo) & (pu <= uhi) & (pv >= vlo) & (pv <= vhi))
            x = ((pu - ulo) / (uhi - ulo) * (S - 1)).clamp(0, S - 1.001)
            y = ((pv - vlo) / (vhi - vlo) * (S - 1)).clamp(0, S - 1.001)
            x, y = torch.where(hit, x, 0.0), torch.where(hit, y, 0.0)
            x0, y0 = x.to(torch.int64), y.to(torch.int64)
            fx, fy = (x - x0).to(torch.float32), (y - y0).to(torch.float32)
            t = texs[i]
            at = lambda dy, dx: t[(y0 + dy) * S + x0 + dx]  # noqa: E731
            val = (at(0, 0) * (1 - fx) * (1 - fy) + at(0, 1) * fx * (1 - fy)
                   + at(1, 0) * (1 - fx) * fy + at(1, 1) * fx * fy)
            shade = torch.where(hit, val, shade)
            best = torch.where(hit, ti, best)
        out[f0:f1] = (shade * 255.0).clamp(0, 255).to(torch.uint8)
    return out
