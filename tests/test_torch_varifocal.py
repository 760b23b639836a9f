"""Per-view intrinsics in the port (ROADMAP C4): twins of
``tests/test_varifocal.py``. The engine runs at the JAX tests' size are
``slow``; each has a cheap twin at 128 keypoints and 120 points. The
JAX package's own run of the varifocal trajectory is held beside the
port's: both recover it, and the constant-K control fails in both."""

import dataclasses

import numpy as np
import pytest
import torch

from structure_from_motion_tpu.config import (
    CapacityConfig,
    FrontendConfig,
    MatcherConfig,
    PipelineConfig,
)
from structure_from_motion_tpu.models import IncrementalSfM as JaxSfM
from structure_from_motion_tpu_torch.io.colmap import export_colmap_text, read_colmap_text
from structure_from_motion_tpu_torch.io.synthetic import synthetic_sequence
from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
from structure_from_motion_tpu_torch.models.tracks import init_state
from structure_from_motion_tpu_torch.utils.checkpoint import load_state, save_state
from tests.test_incremental import umeyama_ate
from tests.test_torch_config import port_config
from tests.test_varifocal import varifocal_sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(kp=512):
    return PipelineConfig(
        frontend=FrontendConfig(max_keypoints=kp, upsample_first_octave=False),
        matcher=MatcherConfig(ratio=0.9),
        capacity=CapacityConfig(max_views=8, max_keypoints=kp, max_points=4096,
                                max_observations=16384),
    )


def _cfg(kp=512):
    return port_config(_jax_cfg(kp))


SIZES = {"full": dict(kp=512, n_points=300), "cheap": dict(kp=128, n_points=120)}


def _seq(size, n_views):
    s = SIZES[size]
    return varifocal_sequence(n_views=n_views, n_points=s["n_points"], kp_cap=s["kp"])


def _varifocal_run(cfg, Ks, frames, with_K=True):
    engine = IncrementalSfM(cfg, Ks[0], frontend="precomputed", seed=0, device="cpu")
    for (xy, d, valid), K in zip(frames, Ks):
        engine.process_features(xy, d, valid, K=K if with_K else None)
    return engine


def _trajectory(size):
    Ks, frames, C_gt, _ = _seq(size, 5)
    cfg = _cfg(SIZES[size]["kp"])
    engine = _varifocal_run(cfg, Ks, frames)
    locs, _ = engine.poses()
    assert len(locs) == len(frames)
    ate = umeyama_ate(locs, C_gt)
    assert ate < 0.05, ate
    np.testing.assert_allclose(engine.state.K.numpy()[: len(frames)], Ks, atol=1e-4)
    wrong = _varifocal_run(cfg, Ks, frames, with_K=False)
    ate_w = umeyama_ate(wrong.poses()[0], C_gt)
    assert ate_w > 3.0 * ate, (ate_w, ate)
    return ate, ate_w


@pytest.mark.slow
def test_per_view_K_recovers_varifocal_trajectory():
    """Twin of ``test_per_view_K_recovers_varifocal_trajectory`` at its size."""
    _trajectory("full")


def test_per_view_K_recovers_varifocal_trajectory_cheap():
    """The cheap twin, and the JAX engine on the same input: both recover
    the trajectory (ATE < 0.05) and both fail the constant-K control."""
    ate, ate_w = _trajectory("cheap")
    Ks, frames, C_gt, _ = _seq("cheap", 5)
    jeng = JaxSfM(_jax_cfg(128), Ks[0], frontend="precomputed", seed=0)
    for (xy, d, valid), K in zip(frames, Ks):
        jeng.process_features(xy, d, valid, K=K)
    assert umeyama_ate(np.asarray(jeng.poses()[0]), C_gt) < 0.05
    assert ate_w > 3.0 * ate


def _array_vs_scalar(size):
    s = SIZES[size]
    K, frames, *_ = synthetic_sequence(n_views=4, n_points=s["n_points"], kp_cap=s["kp"])
    cfg = _cfg(s["kp"])
    a = IncrementalSfM(cfg, K, frontend="precomputed", seed=0, device="cpu")
    b = IncrementalSfM(cfg, np.broadcast_to(K, (cfg.capacity.max_views, 3, 3)),
                       frontend="precomputed", seed=0, device="cpu")
    for f in frames:
        a.process_features(*f)
        b.process_features(*f)
    assert torch.equal(a.state.cam_C, b.state.cam_C)
    assert torch.equal(a.state.points, b.state.points)


@pytest.mark.slow
def test_per_view_K_array_matches_scalar_K_run():
    """Twin of ``test_per_view_K_array_matches_scalar_K_run``: a (V, 3, 3)
    broadcast of one K reproduces the single-K run bit for bit."""
    _array_vs_scalar("full")


def test_per_view_K_array_matches_scalar_K_run_cheap():
    _array_vs_scalar("cheap")


def _slide(size):
    Ks, frames, C_gt, _ = _seq(size, 6)
    cfg = dataclasses.replace(_cfg(SIZES[size]["kp"]), window_size=4, window_mode="slide")
    engine = _varifocal_run(cfg, Ks, frames)
    # the live window holds the LAST window_size frames' intrinsics
    np.testing.assert_allclose(engine.state.K.numpy()[:4], Ks[2:6], atol=1e-4)
    locs, rots = engine.poses()
    assert len(locs) == 6
    assert umeyama_ate(locs, C_gt) < 0.08
    return engine, Ks, locs, rots


@pytest.mark.slow
def test_varifocal_slide_mode_keeps_K_rows_aligned():
    """Twin of ``test_varifocal_slide_mode_keeps_K_rows_aligned``."""
    _slide("full")


def test_varifocal_slide_mode_keeps_K_rows_aligned_cheap():
    _slide("cheap")


def _colmap_slide(size, tmp_path):
    engine, Ks, locs, rots = _slide(size)
    out = str(tmp_path / "colmap")
    export_colmap_text(out, locs, rots, engine.state.K.numpy(), (640, 480), state=engine.state)
    model = read_colmap_text(out)
    # live images 2..5 carry their own K; archived 0..1 inherit the oldest
    # live slot's K (frame 2's)
    np.testing.assert_allclose(model["Ks"][2:], Ks[2:6], atol=1e-3)
    np.testing.assert_allclose(model["Ks"][:2], [Ks[2], Ks[2]], atol=1e-3)
    ref_imgs = {img_id for tr in model["tracks"].values() for img_id, _ in tr}
    assert ref_imgs and ref_imgs <= {3, 4, 5, 6}, ref_imgs


@pytest.mark.slow
def test_colmap_export_heterogeneous_slide_mode(tmp_path):
    """Twin of ``test_colmap_export_heterogeneous_slide_mode``."""
    _colmap_slide("full", tmp_path)


def test_colmap_export_heterogeneous_slide_mode_cheap(tmp_path):
    _colmap_slide("cheap", tmp_path)


def test_checkpoint_backcompat_shared_K(tmp_path):
    """Twin of ``test_checkpoint_backcompat_shared_K``: a checkpoint holding
    one (3, 3) K loads broadcast to the (V, 3, 3) schema."""
    cap = _cfg().capacity
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    st = init_state(cap, K, device="cpu")
    path = str(tmp_path / "state.npz")
    save_state(path, st._replace(K=torch.tensor(K, dtype=torch.float32)), frame=1)
    st2, frame, _, _ = load_state(path, "cpu")
    assert frame == 1 and st2.K.shape == (cap.max_views, 3, 3)
    np.testing.assert_allclose(st2.K[3].numpy(), K, atol=1e-4)
