"""The port's utilities: ``utils/debug.py``, ``utils/profiling.py`` and
``utils/roofline.py``, as the JAX package's tests hold its own."""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from structure_from_motion_tpu.utils import roofline as JRoof
from structure_from_motion_tpu_torch.config import CapacityConfig
from structure_from_motion_tpu_torch.io.synthetic import synthetic_sequence
from structure_from_motion_tpu_torch.models import tracks
from structure_from_motion_tpu_torch.models.batched import BatchedIncrementalSfM
from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
from structure_from_motion_tpu_torch.utils import roofline as TRoof
from structure_from_motion_tpu_torch.utils.debug import nan_guard as tensor_nan_guard
from structure_from_motion_tpu_torch.utils.debug import validate_state
from structure_from_motion_tpu_torch.utils.profiling import device_timer, nan_guard, trace
from tests.test_incremental import umeyama_ate
from tests.test_torch_batched import _cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_device_timer_measures_the_body():
    """Twin of ``tests/test_aux_utils.py::test_device_timer_fetch_bounded``."""
    results = {}
    with device_timer("matmul", results):
        a = torch.ones((256, 256))
        (a @ a).sum()
    assert "matmul" in results and results["matmul"] > 0.0


def test_nan_guard_logs(caplog):
    """Twin of ``tests/test_aux_utils.py::test_nan_guard_logs``, over a dict
    and over a NamedTuple (an SfMState with one poisoned point)."""
    tree = {"ok": torch.ones(3), "bad": torch.tensor([1.0, float("nan")])}
    with caplog.at_level(logging.ERROR, logger="structure_from_motion_tpu_torch"):
        assert nan_guard(tree, "state.") is True
    assert any("bad" in r.message for r in caplog.records)
    assert nan_guard({"ok": torch.ones(3)}) is False
    st = tracks.init_state(CapacityConfig(max_views=2, max_keypoints=4, max_points=4,
                                          max_observations=4), np.eye(3), device="cpu")
    assert nan_guard(st) is False
    points = st.points.clone()
    points[1, 2] = float("inf")
    caplog.clear()
    with caplog.at_level(logging.ERROR, logger="structure_from_motion_tpu_torch"):
        assert nan_guard(st._replace(points=points), "state") is True
    assert any("points" in r.message for r in caplog.records)
    cleaned, n = tensor_nan_guard(points, replace=-1.0)
    assert int(n) == 1 and float(cleaned[1, 2]) == -1.0


def test_profiler_trace_writes_events(tmp_path):
    """Twin of ``tests/test_aux_utils.py::test_profiler_trace_writes_events``:
    ``trace`` writes a ``torch.profiler`` trace for TensorBoard."""
    d = str(tmp_path / "trace")
    with trace(d):
        a = torch.ones((128, 128))
        (a @ a).sum()
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert files and any(f.endswith((".json", ".json.gz", ".pt.trace.json")) for f in files), files


def test_roofline_counts_equal_the_jax_modules_and_peaks_are_the_h100s():
    """The FLOP and byte models count for count against the JAX module's,
    and the peaks are one H100's (3.35 TB/s, 67 TFLOP/s f32, 495 TF32)."""
    assert (TRoof.H100_HBM_BYTES_PER_S, TRoof.H100_F32_FLOPS, TRoof.H100_TF32_FLOPS) == (
        3.35e12, 67e12, 495e12)
    for args in ((2048, 16 * 2048, 128), (256, 512, 128, 2)):
        assert TRoof.matcher_model(*args) == JRoof.matcher_model(*args)
    for kw in (dict(), dict(dense_schur=False, pcg_iters=12), dict(ell_rows=16),
               dict(adaptive=False, ell_rows=8, dense_schur=True)):
        assert TRoof.ba_iteration_model(16, 16384, 65536, **kw) == \
            JRoof.ba_iteration_model(16, 16384, 65536, **kw), kw
    f, b = TRoof.matcher_model(2048, 32768, 128)
    assert TRoof.speed_of_light_seconds(f, b) == max(f / 67e12, b / 3.35e12)
    assert TRoof.sol_pct(2 * TRoof.speed_of_light_seconds(f, b), f, b) == pytest.approx(50.0)


def test_state_invariants_after_run():
    """Twin of ``tests/test_incremental.py::test_state_invariants_after_run``,
    and the same for a lane-stacked state and one lane of it."""
    cfg = _cfg()
    K, frames, *_ = synthetic_sequence(n_views=4)
    engine = IncrementalSfM(cfg, K, frontend="precomputed", device="cpu")
    for f in frames:
        engine.process_features(*f)
    assert validate_state(engine.state) == []
    batched = BatchedIncrementalSfM(cfg, K, batch=2, frontend="precomputed", device="cpu")
    for f in frames:
        batched.process_features(*(np.stack([a, a]) for a in f))
    assert validate_state(batched.state) == []
    assert validate_state(batched.lane_state(1)) == []
    # a broken lane is named
    st = batched.state
    bad = st._replace(num_points=st.num_points + torch.tensor([0, 1], dtype=torch.int32))
    assert validate_state(bad) == [
        f"lane 1: num_points {int(st.num_points[1]) + 1} != valid count "
        f"{int(st.pt_valid[1].sum())}"]


def test_sliding_window_long_sequence_stays_valid():
    """Twin of ``tests/test_incremental.py::test_sliding_window_long_sequence``
    at 8 frames through a window of 5 (128 keypoints): archive plus window
    give every pose, ATE < 0.1, the state stays valid and within capacity."""
    n_frames = 8
    cfg = dataclasses.replace(_cfg(128), window_size=5, window_mode="slide")
    K, frames, C_gt, *_ = synthetic_sequence(n_views=n_frames, n_points=120, kp_cap=128, seed=2)
    engine = IncrementalSfM(cfg, K, frontend="precomputed", device="cpu")
    for f in frames:
        info = engine.process_features(*f)
    assert not info.get("skipped")
    locs, _ = engine.poses()
    assert len(locs) == n_frames
    assert umeyama_ate(locs, C_gt) < 0.1
    assert validate_state(engine.state) == []
    assert int(engine.state.num_points) <= cfg.capacity.max_points
    assert int(engine.state.num_obs) <= cfg.capacity.max_observations


def _two_camera_state():
    cap = CapacityConfig(max_views=4, max_keypoints=64, max_points=64, max_observations=256)
    st = tracks.init_state(cap, np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]]),
                           device="cpu")
    st = tracks.set_camera(st, 0, torch.zeros(3), torch.tensor([1.0, 0, 0, 0]))
    st = tracks.set_camera(st, 1, torch.tensor([1.0, 0, 0]), torch.tensor([1.0, 0, 0, 0]))
    return st


def test_prune_compacts_stores():
    """Twin of ``tests/test_io.py::test_prune_compacts_stores``."""
    st = _two_camera_state()
    X = np.array([[0.0, 0, 5], [1.0, 1, 6], [-1.0, 0.5, 7]], np.float32)
    st, ids, _ = tracks.allocate_points(st, torch.tensor(X), torch.ones(3, dtype=torch.bool))
    for cam, C in ((0, np.zeros(3)), (1, np.array([1.0, 0, 0]))):
        xc = X - C
        uvs = np.stack([100 * xc[:, 0] / xc[:, 2] + 32, 100 * xc[:, 1] / xc[:, 2] + 32], 1)
        if cam == 1:
            uvs[1] += 500.0  # poison point 1 in view 1
        st = tracks.append_observations(st, torch.full((3,), cam), ids,
                                        torch.tensor(uvs, dtype=torch.float32),
                                        torch.ones(3, dtype=torch.bool))
    assert int(st.num_obs) == 6 and int(st.num_points) == 3
    st2, n_obs_dropped, n_pts_dropped = tracks.prune_observations(st, 4.0)
    assert int(n_obs_dropped) == 1 and int(n_pts_dropped) == 1
    assert int(st2.num_points) == 2 == int(st2.pt_valid.sum())
    assert int(st2.num_obs) == 4 == int(st2.obs_valid.sum())
    assert validate_state(st2) == []
    st3, _, _ = tracks.allocate_points(st2, torch.ones((1, 3)), torch.ones(1, dtype=torch.bool))
    assert int(st3.num_points) == 3


def test_capacity_overflow_is_counted():
    """Twin of ``tests/test_io.py::test_capacity_overflow_is_counted``."""
    cap = CapacityConfig(max_views=2, max_keypoints=8, max_points=4, max_observations=4)
    st = tracks.init_state(cap, np.eye(3), device="cpu")
    st = tracks.set_camera(st, 0, torch.zeros(3), torch.tensor([1.0, 0, 0, 0]))
    st, ids, stored = tracks.allocate_points(st, torch.arange(18.0).reshape(6, 3),
                                             torch.ones(6, dtype=torch.bool))
    assert int(st.num_points) == 4 and int(st.dropped_points) == 2
    assert int(stored.sum()) == 4 and (ids[stored] < 4).all()
    st = tracks.append_observations(st, torch.zeros(6, dtype=torch.int32), ids.clamp(0, 3),
                                    torch.ones((6, 2)), torch.ones(6, dtype=torch.bool))
    assert int(st.num_obs) == 4 and int(st.dropped_obs) == 2
    problems = validate_state(st)
    assert any("overflow" in p and "points" in p for p in problems), problems
    assert any("overflow" in p and "observations" in p for p in problems), problems
