"""Lens distortion: the Brown-Conrady (OpenCV) radial-tangential model (port
of ``structure_from_motion_tpu/ops/distortion.py``).

The geometry stack (epipolar, PnP, triangulation, BA) stays pinhole-only;
measurements are undistorted ONCE at the feature-ingest boundary
(``models/incremental._frame_step``): detected keypoint coordinates go
through the inverse distortion model on the device, after which every
downstream residual is exactly the pinhole residual -- the standard SfM
treatment of known calibration, a handful of elementwise operations a frame.

Model (OpenCV convention, coefficients ``(k1, k2, p1, p2, k3)``), applied
to NORMALIZED camera coordinates x, y (after K^-1):

    r^2   = x^2 + y^2
    rad   = 1 + k1 r^2 + k2 r^4 + k3 r^6
    x_d   = x * rad + 2 p1 x y + p2 (r^2 + 2 x^2)
    y_d   = y * rad + p1 (r^2 + 2 y^2) + 2 p2 x y

The inverse has no closed form; ``undistort_normalized`` runs a fixed count
of NEWTON iterations on the 2x2 system (closed-form Jacobian of the forward
model): float32-exact across a frame in <= 6 iterations even for strong
barrel coefficients, where the classic fixed-point scheme is still pixels
off at the corners.
"""

from __future__ import annotations

import torch
from torch import Tensor as Array

# full OpenCV coefficient order; shorter user tuples are zero-padded
NUM_COEFFS = 5


def pad_coeffs(coeffs) -> tuple[float, ...]:
    """Normalise a user coefficient sequence to (k1, k2, p1, p2, k3)."""
    c = tuple(float(v) for v in coeffs)
    if len(c) > NUM_COEFFS:
        raise ValueError(f"at most {NUM_COEFFS} distortion coefficients, got {len(c)}")
    return c + (0.0,) * (NUM_COEFFS - len(c))


def distort_normalized(xyn: Array, coeffs) -> Array:
    """Forward model on (..., 2) normalized camera coordinates."""
    k1, k2, p1, p2, k3 = pad_coeffs(coeffs)
    x, y = xyn[..., 0], xyn[..., 1]
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xyd: Array, coeffs, iterations: int = 8) -> Array:
    """Inverse model on (..., 2) distorted normalized coordinates.

    Newton iteration on F(x) = distort(x) - x_d with the closed-form 2x2
    Jacobian of the forward model, fixed trip count (no host read)."""
    k1, k2, p1, p2, k3 = pad_coeffs(coeffs)
    xd, yd = xyd[..., 0], xyd[..., 1]
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        drad = k1 + r2 * (2.0 * k2 + r2 * (3.0 * k3))
        fx = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xd
        fy = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y - yd
        # Jacobian of the forward model (symmetric off-diagonal)
        a = rad + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
        b = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
        c = rad + 2.0 * y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x
        det = a * c - b * b
        # guard a (theoretically possible, practically out-of-frame)
        # singular fold: fall back to a plain gradient-free damped step
        det = torch.where(det.abs() < 1e-12, torch.ones_like(det), det)
        x = x - (c * fx - b * fy) / det
        y = y - (a * fy - b * fx) / det
    return torch.stack([x, y], dim=-1)


def _to_normalized(xy: Array, K: Array) -> Array:
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    yn = (xy[..., 1] - cy) / fy
    xn = (xy[..., 0] - cx - skew * yn) / fx
    return torch.stack([xn, yn], dim=-1)


def _to_pixels(xyn: Array, K: Array) -> Array:
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    u = fx * xyn[..., 0] + skew * xyn[..., 1] + cx
    v = fy * xyn[..., 1] + cy
    return torch.stack([u, v], dim=-1)


def undistort_pixels(xy: Array, K: Array, coeffs, iterations: int = 8) -> Array:
    """Map DISTORTED pixel coordinates to ideal pinhole pixel coordinates
    under the same K (i.e. cv2.undistortPoints with P=K)."""
    return _to_pixels(undistort_normalized(_to_normalized(xy, K), coeffs, iterations), K)


def distort_pixels(xy: Array, K: Array, coeffs) -> Array:
    """Map ideal pinhole pixel coordinates to distorted pixel coordinates
    (the forward model; used by tests and synthetic-data generation)."""
    return _to_pixels(distort_normalized(_to_normalized(xy, K), coeffs), K)
