"""Lens distortion of the PyTorch port against the JAX package's, function
by function on the same seeded points. Tolerance 1e-6 on normalised
coordinates of magnitude <= 1 (a few f32 ulps; both run the same f32
arithmetic in the same order) and 1e-6 x the focal length on pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.ops import distortion as JD
from structure_from_motion_tpu_torch.ops import distortion as TD

COEFFS = [(-0.28, 0.09), (-0.3, 0.1, 0.001, -0.002), (0.12, -0.05, 0.002, 0.001, 0.01)]
K = np.array([[570.0, 0.5, 640.0], [0.0, 565.0, 480.0], [0.0, 0.0, 1.0]], np.float32)


def _points(seed, n=500):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9, 0.9, size=(n, 2)).astype(np.float32)


@pytest.mark.parametrize("coeffs", COEFFS)
def test_normalized_functions_match_jax(coeffs):
    xyn = _points(len(coeffs))
    for name in ("distort_normalized", "undistort_normalized"):
        got = getattr(TD, name)(torch.from_numpy(xyn), coeffs).numpy()
        want = np.asarray(getattr(JD, name)(jnp.asarray(xyn), coeffs))
        assert got.dtype == np.float32 and got.shape == xyn.shape
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("coeffs", COEFFS)
def test_pixel_functions_match_jax(coeffs):
    xy = (_points(10 + len(coeffs)) * [600.0, 450.0] + [640.0, 480.0]).astype(np.float32)
    for name in ("distort_pixels", "undistort_pixels"):
        got = getattr(TD, name)(torch.from_numpy(xy), torch.from_numpy(K), coeffs).numpy()
        want = np.asarray(getattr(JD, name)(jnp.asarray(xy), jnp.asarray(K), coeffs))
        np.testing.assert_allclose(got, want, atol=1e-6 * 570.0, err_msg=name)


@pytest.mark.parametrize("coeffs", COEFFS)
def test_round_trip_and_batched_shapes(coeffs):
    xy = torch.from_numpy((_points(20) * [600.0, 450.0] + [640.0, 480.0]).astype(np.float32))
    Kt = torch.from_numpy(K)
    back = TD.distort_pixels(TD.undistort_pixels(xy, Kt, coeffs), Kt, coeffs)
    assert float((back - xy).abs().max()) < 2e-3  # f32 at ~1000 px: ulp 6e-5, a few steps
    moved = TD.undistort_pixels(xy, Kt, coeffs) - xy
    assert float(moved.abs().max()) > 1.0
    stacked = TD.undistort_normalized(torch.from_numpy(_points(21)).reshape(5, 100, 2), coeffs)
    assert stacked.shape == (5, 100, 2)


def test_zero_coefficients_are_the_identity_and_padding():
    xyn = torch.from_numpy(_points(30))
    for coeffs in ((), (0.0, 0.0), (0.0,) * 5):
        assert torch.equal(TD.distort_normalized(xyn, coeffs), xyn)
        assert torch.equal(TD.undistort_normalized(xyn, coeffs), xyn)
    assert TD.pad_coeffs((0.1, 0.2)) == JD.pad_coeffs((0.1, 0.2)) == (0.1, 0.2, 0.0, 0.0, 0.0)
    assert TD.NUM_COEFFS == JD.NUM_COEFFS
    with pytest.raises(ValueError, match="at most 5"):
        TD.pad_coeffs(range(6))


def test_engine_undistorts_keypoints_once_at_ingest():
    """``config.distortion`` set: the stored keypoints of a view are the
    undistorted ones (the JAX package's ingest), and the engine no longer
    refuses the configuration."""
    from structure_from_motion_tpu_torch.config import (
        CapacityConfig,
        FrontendConfig,
        PipelineConfig,
    )
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    coeffs = (-0.2, 0.05)
    cfg = PipelineConfig(
        frontend=FrontendConfig(max_keypoints=64, upsample_first_octave=False),
        capacity=CapacityConfig(max_views=4, max_keypoints=64, max_points=256,
                                max_observations=1024),
        distortion=coeffs,
    )
    rng = np.random.default_rng(5)
    xy = (rng.uniform(0, 1, size=(64, 2)) * [1280, 960]).astype(np.float32)
    desc = rng.normal(size=(64, 128)).astype(np.float32)
    engine = IncrementalSfM(cfg, K, frontend="precomputed", device="cpu")
    engine.process_features(xy, desc, np.ones(64, bool))
    want = np.asarray(JD.undistort_pixels(jnp.asarray(xy), jnp.asarray(K), coeffs))
    np.testing.assert_allclose(engine.state.kp_xy[0].numpy(), want, atol=1e-6 * 570.0)
