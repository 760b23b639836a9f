"""The port's two-view reconstruction and the public geometry helpers,
each against its JAX counterpart on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRotation

from structure_from_motion_tpu.config import (
    CapacityConfig,
    FrontendConfig,
    PipelineConfig,
    RansacConfig,
)
from structure_from_motion_tpu.ops import epipolar as JE
from structure_from_motion_tpu.ops import reproj as JR
from structure_from_motion_tpu.ops import triangulation as JT
from structure_from_motion_tpu.utils import geometry as JG
from structure_from_motion_tpu.utils import rotations as JRot
from structure_from_motion_tpu_torch.device import generator
from structure_from_motion_tpu_torch.models.two_view import two_view_reconstruction
from structure_from_motion_tpu_torch.ops import epipolar as TE
from structure_from_motion_tpu_torch.ops import reproj as TR
from structure_from_motion_tpu_torch.ops import triangulation as TT
from structure_from_motion_tpu_torch.utils import geometry as TG
from structure_from_motion_tpu_torch.utils import rotations as TRot
from tests.test_torch_config import port_config

T = torch.from_numpy

CFG = port_config(PipelineConfig(
    frontend=FrontendConfig(max_keypoints=512, upsample_first_octave=False),
    fundamental_ransac=RansacConfig(inlier_threshold=2.0, iteration=256),
    capacity=CapacityConfig(max_views=4, max_keypoints=512, max_points=2048,
                            max_observations=8192),
))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_view_synthetic_ground_truth():
    """Twin of ``tests/test_two_view.py::test_two_view_synthetic_ground_truth``
    (the same scene, thresholds and gauge)."""
    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    n = 300
    X = rng.uniform([-4, -3, 8], [4, 3, 20], size=(n, 3))
    R2 = ScipyRotation.from_rotvec([0.03, -0.1, 0.02]).as_matrix()
    C2 = np.array([1.0, 0.1, 0.2])
    C2 /= np.linalg.norm(C2)

    def project(R, C):
        Xc = (R.T @ (X - C).T).T
        return (Xc[:, :2] / Xc[:, 2:3]) * [500, 500] + [320, 240]

    cap = 512
    pad = np.zeros((cap - n, 2))
    u1 = torch.tensor(np.vstack([project(np.eye(3), np.zeros(3)), pad]), dtype=torch.float32)
    u2 = torch.tensor(np.vstack([project(R2, C2), pad]), dtype=torch.float32)
    valid = torch.arange(cap) < n
    res = two_view_reconstruction(generator(torch.device("cpu"), 0), u1, u2, valid,
                                  torch.tensor(K, dtype=torch.float32), CFG)
    assert np.linalg.norm(res.C.numpy() - C2) < 1e-2, res.C
    dR = ScipyRotation.from_matrix(res.R.numpy().astype(np.float64) @ R2.T).magnitude()
    assert np.degrees(dR) < 0.5
    assert int(res.point_valid.sum()) > 0.9 * n
    assert float(res.reprojection_px) < 0.5
    assert np.abs(res.points.numpy()[:n, :3] - X).max() < 0.2


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(3)
    F = rng.normal(size=(3, 3)).astype(np.float32)
    ref = rng.uniform(0, 640, size=(40, 2)).astype(np.float32)
    que = rng.uniform(0, 480, size=(40, 2)).astype(np.float32)
    mask = rng.random(40) < 0.8
    return F, ref, que, mask


def test_epipolar_helpers_match_jax(pair):
    """``epipolar_errors`` (with a hypothesis axis), ``point_line_distances``
    and ``mean_epipolar_constraint``, rtol 1e-5."""
    F, ref, que, mask = pair
    Fs = np.stack([F, 2 * F]).astype(np.float32)
    rh = np.concatenate([ref, np.ones((40, 1), np.float32)], 1)
    qh = np.concatenate([que, np.ones((40, 1), np.float32)], 1)
    np.testing.assert_allclose(TE.epipolar_errors(T(Fs), T(rh), T(qh)).numpy(),
                               np.asarray(JE.epipolar_errors(*map(jnp.asarray, (Fs, rh, qh)))),
                               rtol=1e-5)
    np.testing.assert_allclose(TE.point_line_distances(T(F), T(ref), T(que)).numpy(),
                               np.asarray(JE.point_line_distances(*map(jnp.asarray,
                                                                       (F, ref, que)))),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(TE.mean_epipolar_constraint(T(F), T(ref), T(que), T(mask))),
        float(JE.mean_epipolar_constraint(*map(jnp.asarray, (F, ref, que, mask)))), rtol=1e-5)


def test_observation_residual_jacobians_match_jax():
    """One observation's residual and Jacobian blocks, atol 1e-5."""
    rng = np.random.default_rng(4)
    C = rng.normal(size=3).astype(np.float32)
    q = (np.float32([1, 0, 0, 0]) + 0.1 * rng.normal(size=4)).astype(np.float32)
    X = (rng.normal(size=3) + [0, 0, 6]).astype(np.float32)
    meas = rng.normal(size=2).astype(np.float32) * 0.1
    got = TR.observation_residual_jacobians(T(C), T(q), T(X), T(meas))
    want = JR.observation_residual_jacobians(*map(jnp.asarray, (C, q, X, meas)))
    assert [g.shape for g in got] == [(2,), (2, 7), (2, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_rotation_helpers_match_jax():
    """``quat_multiply`` (batched) and ``rotation_is_valid``."""
    rng = np.random.default_rng(5)
    a, b = (rng.normal(size=(6, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(TRot.quat_multiply(T(a), T(b)).numpy(),
                               np.asarray(JRot.quat_multiply(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)
    Rs = np.stack([ScipyRotation.from_rotvec(rng.normal(size=3)).as_matrix() for _ in range(3)]
                  + [np.diag([1.0, 1.0, -1.0]), 1.01 * np.eye(3)]).astype(np.float32)
    got = TRot.rotation_is_valid(T(Rs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JRot.rotation_is_valid(jnp.asarray(Rs))))
    np.testing.assert_array_equal(got, [True, True, True, False, False])


def test_geometry_helpers_match_jax():
    """``compose_K``, ``transform_world_to_camera`` and ``project_with_depth``
    (batched), and ``mean_reprojection_error``, atol 1e-5 relative."""
    rng = np.random.default_rng(6)
    np.testing.assert_array_equal(TG.compose_K(500.0, 510.0, 320.0, 240.0).numpy(),
                                  np.asarray(JG.compose_K(500.0, 510.0, 320.0, 240.0)))
    R = ScipyRotation.from_rotvec([0.1, -0.2, 0.05]).as_matrix().astype(np.float32)
    C = np.float32([0.5, -0.2, 0.1])
    X = (rng.normal(size=(2, 30, 3)) + [0, 0, 8]).astype(np.float32)
    np.testing.assert_allclose(TG.transform_world_to_camera(T(X), T(R), T(C)).numpy(),
                               np.asarray(JG.transform_world_to_camera(*map(jnp.asarray,
                                                                            (X, R, C)))),
                               atol=1e-5)
    K = TG.compose_K(500.0, 500.0, 320.0, 240.0)
    P = TG.camera_projection(K, T(R), T(C))
    got = TG.project_with_depth(P, T(X))
    want = JG.project_with_depth(jnp.asarray(P.numpy()), jnp.asarray(X))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-3)
    P2 = np.stack([P.numpy(), TG.camera_projection(K, torch.eye(3), torch.zeros(3)).numpy()])
    Xh = np.concatenate([X[0], np.ones((30, 1), np.float32)], 1)
    uv = np.asarray(rng.uniform(0, 640, size=(30, 2, 2)), np.float32)
    m = rng.random((30, 2)) < 0.7
    np.testing.assert_allclose(
        float(TT.mean_reprojection_error(T(P2), T(Xh), T(uv), T(m))),
        float(JT.mean_reprojection_error(*map(jnp.asarray, (P2, Xh, uv, m)))), rtol=1e-5)
