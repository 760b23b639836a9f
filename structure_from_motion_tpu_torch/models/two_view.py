"""Standalone two-view metric reconstruction (port of
``structure_from_motion_tpu/models/two_view.py``).

Given correspondences of two views, recover the relative pose (baseline
normalised to 1) and a triangulated point cloud: RANSAC F, E and its four
pose candidates, cheirality, the essential-manifold refinement, and the
triangulation LM. The JAX package draws its RANSAC hypotheses from a
``jax.random`` key; here they come from a ``torch.Generator`` or are given
as ``(H, 8)`` index sets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_from_motion_tpu_torch.config import PipelineConfig
from structure_from_motion_tpu_torch.ops.campose import (
    candidate_projections,
    decompose_essential,
    disambiguate_poses,
    refine_relative_pose,
)
from structure_from_motion_tpu_torch.ops.epipolar import (
    essential_from_fundamental,
    find_fundamental,
)
from structure_from_motion_tpu_torch.ops.ransac import sample_index_sets
from structure_from_motion_tpu_torch.ops.triangulation import (
    linear_triangulate,
    mean_reprojection_error,
    refine_triangulate,
)
from structure_from_motion_tpu_torch.utils.geometry import (
    camera_projection,
    normalized_camera_coords,
)


class TwoViewResult(NamedTuple):
    R: torch.Tensor  # (3, 3) cam-to-world rotation of view 2 (view 1 at identity)
    C: torch.Tensor  # (3,) centre of view 2 (unit-scale baseline)
    points: torch.Tensor  # (N, 4) homogeneous triangulated points
    point_valid: torch.Tensor  # (N,) bool (F-inlier and in front of both cameras)
    f_inliers: torch.Tensor  # (N,) bool
    reprojection_px: torch.Tensor  # () mean pixel reprojection error over valid points


def two_view_reconstruction(draws, uv1, uv2, valid, K, config: PipelineConfig) -> TwoViewResult:
    """Correspondences (N, 2) + (N, 2) with a validity mask -> metric
    two-view reconstruction. ``draws`` is a ``torch.Generator`` or the
    RANSAC index sets (H, 8) themselves."""
    rc = config.fundamental_ransac
    idx_sets = (sample_index_sets(draws, valid, rc.num_hypotheses, 8)
                if isinstance(draws, torch.Generator) else draws)
    F = find_fundamental(idx_sets, uv1, uv2, valid, rc)
    cands = decompose_essential(essential_from_fundamental(F.F, K, K))
    P_ref = camera_projection(K, torch.eye(3, dtype=K.dtype, device=K.device),
                              torch.zeros(3, dtype=K.dtype, device=K.device))
    P_cands = candidate_projections(K, cands)
    uv = torch.stack([uv1, uv2], dim=1)
    obs_mask = torch.stack([valid, valid], dim=1)
    X4 = torch.stack([linear_triangulate(torch.stack([P_ref, P2]), uv, obs_mask)
                      for P2 in P_cands])
    best, _, cheir_ok = disambiguate_poses(P_ref, P_cands, X4, valid)
    R2, _, C2 = refine_relative_pose(
        cands.R[best], cands.t[best], normalized_camera_coords(K, uv1),
        normalized_camera_coords(K, uv2), valid & F.inliers,
    )
    P_pair = torch.stack([P_ref, camera_projection(K, R2, C2)])
    X2l = linear_triangulate(P_pair, uv, obs_mask)
    Xh = refine_triangulate(P_pair, uv, torch.stack([cheir_ok, cheir_ok], dim=1), X2l,
                            config.triangulation_lm)
    keep = cheir_ok & F.inliers
    err = mean_reprojection_error(P_pair, Xh, uv, torch.stack([keep, keep], dim=1))
    return TwoViewResult(R=R2, C=C2, points=Xh, point_valid=keep, f_inliers=F.inliers,
                         reprojection_px=err)
