"""Homogeneous-coordinate and pinhole primitives (port of
``structure_from_motion_tpu/utils/geometry.py``).

Pose convention: ``R`` cam-to-world, ``C`` the centre in world coordinates,
projection ``P = K [R^T | -R^T C]``.
"""

from __future__ import annotations

import torch


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """``(..., N, D)`` -> ``(..., N, D+1)`` with a trailing 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def from_homogeneous(pts_h: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``(..., N, D+1)`` -> ``(..., N, D)`` by dividing out the last coord."""
    w = pts_h[..., -1:]
    denom = torch.where(w.abs() < eps, torch.where(w < 0, -eps, eps), w)
    return pts_h[..., :-1] / denom


def compose_K(fx: float, fy: float, cx: float, cy: float) -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def camera_extrinsic(R: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """World->camera extrinsic ``[R^T | -R^T C]`` of shape ``(..., 3, 4)``."""
    Rt = R.transpose(-1, -2)
    return torch.cat([Rt, -(Rt @ C[..., None])], dim=-1)


def camera_projection(K: torch.Tensor, R: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Full projection ``P = K [R^T | -R^T C]`` of shape ``(..., 3, 4)``."""
    return K @ camera_extrinsic(R, C)


def transform_world_to_camera(X: torch.Tensor, R: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """World points ``(..., N, 3)`` -> camera frame ``R^T (X - C)``."""
    return (X - C[..., None, :]) @ R


def project_points(P: torch.Tensor, X: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """World points ``(..., N, 3)`` through ``(..., 3, 4)`` -> pixels ``(..., N, 2)``."""
    return from_homogeneous(to_homogeneous(X) @ P.transpose(-1, -2), eps)


def normalized_camera_coords(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels ``(..., N, 2)`` -> normalised camera coords by the zero-skew
    ``K^-1`` (one K per trailing point axis)."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def normalized_camera_coords_per_obs(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Per-observation ``K^-1``: ``K`` (..., 3, 3) and ``uv`` (..., 2) share
    leading axes element-wise."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def project_with_depth(P: torch.Tensor, X: torch.Tensor, eps: float = 1e-12):
    """:func:`project_points` and the projective depth (positive in front)."""
    x = to_homogeneous(X) @ P.transpose(-1, -2)
    return from_homogeneous(x, eps), x[..., 2]
