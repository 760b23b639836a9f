"""Rendered synthetic scene with EXACT ground-truth poses.

Both end-to-end anchors the test suite had before this module — the
reference's golden ``view_pose.pkl`` and the cv2 full-trajectory oracle —
are outputs of imperfect solvers, so every ATE gate inherited their error
(the measured ~10% "gap" vs the golden is the golden's own bias, see
``examples/oracle_crosscheck.py``). This renderer provides the only
unbiased gate: images synthesised by exact pinhole projection of a known
scene, so the true K, camera centers, and rotations are known to machine
precision, and arbitrarily long sequences with genuinely novel viewpoints
exist (the upenn loop only ping-pongs 6 photographs).

Scene: a textured room corner (back wall + side wall + floor), rendered by
ray casting on the host (numpy) — the generator is data preparation, not
device code. Textures are multi-octave smoothed noise: dense blob
structure at every scale, exactly what a DoG detector keys on.

Conventions match the engine: cam-to-world rotation R, center C, world
point X maps to pixels via K [R^T | -R^T C] (``utils/geometry.
camera_projection``; the reference's convention, ``campose_processor.py``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_scene_sequence", "synthetic_scene_poses", "default_synthetic_K",
           "synthetic_sequence"]


def _texture(seed: int, size: int = 512) -> np.ndarray:
    """Multi-octave smoothed-noise texture in [0, 1], (size, size) f32.

    Four octaves of box-blurred uniform noise: coarse blobs give DoG
    extrema at high sigma, fine grain gives them at low sigma, and the
    octave mix avoids the degenerate repeating patterns (checkerboards)
    that alias descriptor matching."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    for octave, weight in ((4, 0.45), (16, 0.3), (64, 0.25)):
        small = rng.uniform(0, 1, (octave, octave)).astype(np.float32)
        # bilinear upsample to full size
        idx = np.linspace(0, octave - 1, size, dtype=np.float32)
        i0 = np.clip(idx.astype(np.int32), 0, octave - 2)
        f = idx - i0
        row = small[i0] * (1 - f)[:, None] + small[i0 + 1] * f[:, None]
        up = row[:, i0] * (1 - f)[None, :] + row[:, i0 + 1] * f[None, :]
        tex += weight * up
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return tex


def default_synthetic_K(size=(480, 640)) -> np.ndarray:
    H, W = size
    f = 0.9 * W
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float64)


# each plane: (normal, offset, u-axis, v-axis, (u_lo, u_hi, v_lo, v_hi))
# with point-on-plane test  normal . X == offset. Ray casting takes the
# NEAREST positive hit, so the boxes occlude the room correctly. The boxes
# matter geometrically, not just visually: with the back wall alone most
# correspondences are coplanar and fundamental-matrix RANSAC is degenerate
# (any H-compatible F fits) — depth structure at 7-11 units breaks that.
_PLANES = (
    # room: back wall (z = 14), side wall (x = -6), floor (y = 3)
    (np.array([0.0, 0, 1]), 14.0, np.array([1.0, 0, 0]), np.array([0.0, 1, 0]),
     (-9.0, 9.0, -7.0, 7.0)),
    (np.array([1.0, 0, 0]), -6.0, np.array([0.0, 0, 1]), np.array([0.0, 1, 0]),
     (2.0, 14.0, -7.0, 7.0)),
    (np.array([0.0, 1, 0]), 3.0, np.array([1.0, 0, 0]), np.array([0.0, 0, 1]),
     (-9.0, 9.0, 2.0, 14.0)),
    # box A on the floor, front/top/right faces (z in [8, 10])
    (np.array([0.0, 0, 1]), 8.0, np.array([1.0, 0, 0]), np.array([0.0, 1, 0]),
     (-3.0, -0.5, 0.5, 3.0)),
    (np.array([0.0, 1, 0]), 0.5, np.array([1.0, 0, 0]), np.array([0.0, 0, 1]),
     (-3.0, -0.5, 8.0, 10.0)),
    (np.array([1.0, 0, 0]), -0.5, np.array([0.0, 0, 1]), np.array([0.0, 1, 0]),
     (8.0, 10.0, 0.5, 3.0)),
    # box B, taller and deeper (z in [10.5, 12.5])
    (np.array([0.0, 0, 1]), 10.5, np.array([1.0, 0, 0]), np.array([0.0, 1, 0]),
     (2.0, 4.5, -1.5, 3.0)),
    (np.array([0.0, 1, 0]), -1.5, np.array([1.0, 0, 0]), np.array([0.0, 0, 1]),
     (2.0, 4.5, 10.5, 12.5)),
    (np.array([1.0, 0, 0]), 2.0, np.array([0.0, 0, 1]), np.array([0.0, 1, 0]),
     (10.5, 12.5, -1.5, 3.0)),
    # hanging slab near the ceiling between the boxes (z in [9, 11])
    (np.array([0.0, 1, 0]), -2.5, np.array([1.0, 0, 0]), np.array([0.0, 0, 1]),
     (-2.0, 1.5, 9.0, 11.0)),
    (np.array([0.0, 0, 1]), 9.0, np.array([1.0, 0, 0]), np.array([0.0, 1, 0]),
     (-2.0, 1.5, -2.5, -2.0)),
)


def _look_at(C: np.ndarray, target: np.ndarray, roll: float = 0.0) -> np.ndarray:
    """Cam-to-world rotation whose +z axis looks from C at ``target``."""
    z = target - C
    z = z / np.linalg.norm(z)
    # world +y is "down" (the floor plane sits at y = +3), so the camera's
    # y axis (image-down) aligns with +y at zero roll: x right, y down,
    # z forward — the K [R^T | -R^T C] convention's standard frame
    up = np.array([np.sin(roll), np.cos(roll), 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)  # columns = camera axes in world


def synthetic_scene_poses(
    n_frames: int = 100,
    size: tuple = (480, 640),
    path_scale: float = 1.0,
    loops: float = 1.0,
):
    """(K, C_gt (F,3), R_gt (F,3,3)) of :func:`synthetic_scene_sequence`
    WITHOUT rendering the images — the camera path is analytic, so scripts
    that re-score a checkpointed run (e.g. the mesh-sharded global-BA
    re-solve) can rebuild the exact ground truth for free. Poses are
    independent of the texture ``seed``."""
    K = default_synthetic_K(size)
    t = np.linspace(0.0, loops * 2 * np.pi, n_frames, endpoint=False)
    C_gt = np.stack(
        [
            2.4 * path_scale * np.sin(t),
            0.9 * path_scale * np.sin(2 * t + 0.9),
            1.8 * path_scale * np.sin(0.5 * t + 0.3),
        ],
        axis=1,
    )
    target = np.array([1.0, -0.5, 12.0])
    R_gt = np.stack(
        [
            _look_at(C_gt[i], target, roll=0.08 * np.sin(3 * t[i]))
            for i in range(n_frames)
        ]
    )
    return K, C_gt, R_gt


def synthetic_scene_sequence(
    n_frames: int = 100,
    size: tuple = (480, 640),
    seed: int = 0,
    path_scale: float = 1.0,
    loops: float = 1.0,
):
    """Render an ``n_frames`` camera path through the textured corner scene.

    Returns ``(imgs (F,H,W) uint8, K (3,3) f64, C_gt (F,3) f64,
    R_gt (F,3,3) f64)`` — poses in the engine's cam-to-world convention, so
    ``IncrementalSfM.poses()`` output aligns against (C_gt, R_gt) directly.

    The path is a smooth Lissajous sweep inside the room (lateral + vertical
    + dolly motion, slight roll), every frame a genuinely novel viewpoint —
    with ``loops > 1`` the sweep revisits earlier viewpoints (loop-closure
    style) without ever duplicating a frame exactly.
    """
    H, W = size
    K, C_gt, R_gt = synthetic_scene_poses(n_frames, size, path_scale, loops)
    Kinv = np.linalg.inv(K)
    textures = [_texture(seed + 7 * i) for i in range(len(_PLANES))]

    # pixel-ray directions in camera coords, shared across frames
    u, v = np.meshgrid(
        np.arange(W, dtype=np.float64) + 0.5,
        np.arange(H, dtype=np.float64) + 0.5,
    )
    rays_cam = np.stack([u, v, np.ones_like(u)], axis=-1) @ Kinv.T  # (H,W,3)

    imgs = np.empty((n_frames, H, W), np.uint8)
    for f in range(n_frames):
        d = rays_cam @ R_gt[f].T  # (H,W,3) world-frame ray directions
        C = C_gt[f]
        best_t = np.full((H, W), np.inf)
        shade = np.full((H, W), 0.5, np.float32)
        for (n, off, au, av, (ulo, uhi, vlo, vhi)), tex in zip(_PLANES, textures):
            denom = d @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                ti = (off - C @ n) / denom
            P = C + ti[..., None] * d
            pu = P @ au
            pv = P @ av
            hit = (
                (ti > 0.1)
                & (np.abs(denom) > 1e-9)
                & (ti < best_t)
                & (pu >= ulo) & (pu <= uhi) & (pv >= vlo) & (pv <= vhi)
            )
            S = tex.shape[0]
            x = np.clip((pu - ulo) / (uhi - ulo) * (S - 1), 0, S - 1.001)
            y = np.clip((pv - vlo) / (vhi - vlo) * (S - 1), 0, S - 1.001)
            x0 = x.astype(np.int32)
            y0 = y.astype(np.int32)
            fx = (x - x0).astype(np.float32)
            fy = (y - y0).astype(np.float32)
            val = (
                tex[y0, x0] * (1 - fx) * (1 - fy)
                + tex[y0, x0 + 1] * fx * (1 - fy)
                + tex[y0 + 1, x0] * (1 - fx) * fy
                + tex[y0 + 1, x0 + 1] * fx * fy
            )
            shade = np.where(hit, val, shade)
            best_t = np.where(hit, ti, best_t)
        imgs[f] = np.clip(shade * 255.0, 0, 255).astype(np.uint8)
    return imgs, K, C_gt, R_gt


def synthetic_sequence(n_views=5, n_points=300, kp_cap=512, seed=0, noise=0.0):
    """Precomputed features with perfect correspondences: views on an arc
    looking at a point cloud, every point visible in every view, descriptors
    unique random codes shared across views (the same numbers as the JAX
    package's ``tests/test_incremental.synthetic_sequence`` for the same
    seed). Returns ``(K, frames, C_gt, R_gt, X)``; ``frames`` is a list of
    ``(xy (kp_cap, 2), desc (kp_cap, 128), valid (kp_cap,))``."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    X = rng.uniform([-4, -3, 10], [4, 3, 20], size=(n_points, 3))
    desc_codes = rng.normal(size=(n_points, 128)).astype(np.float32) * 10

    frames, C_gt, R_gt = [], [], []
    for v in range(n_views):
        C = np.array([v * 1.0, 0.05 * v**2, 0.3 * v])
        a = -0.06 * v  # rotation about the y axis
        R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]])
        C_gt.append(C)
        R_gt.append(R)
        Xc = (R.T @ (X - C).T).T
        uv = Xc[:, :2] / Xc[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        uv = uv + rng.normal(size=uv.shape) * noise
        # fill fixed-capacity buffers (shuffled order per view)
        perm = rng.permutation(n_points)
        xy = np.zeros((kp_cap, 2), np.float32)
        d = np.zeros((kp_cap, 128), np.float32)
        valid = np.zeros(kp_cap, bool)
        xy[:n_points] = uv[perm]
        d[:n_points] = desc_codes[perm]
        valid[:n_points] = True
        frames.append((xy, d, valid))
    return K, frames, np.stack(C_gt), np.stack(R_gt), X
