"""Keyframe gate of the PyTorch port against the JAX package's: a sequence
in which every real frame is followed by near-identical frames (sub-pixel
jitter) goes through both engines on precomputed features. The same frames
must be skipped, the accepted-input bookkeeping (``keyframe_indices``,
``_input_index``) must be equal, and it must survive a checkpoint in both
directions. The flow statistic itself is held to 1e-3 px (f32 distances
through two matchers)."""

import numpy as np
import pytest

from structure_from_motion_tpu.config import (
    CapacityConfig,
    FrontendConfig,
    MatcherConfig,
    PipelineConfig,
)
from structure_from_motion_tpu.models import IncrementalSfM as JaxSfM
from structure_from_motion_tpu_torch.io.synthetic import synthetic_sequence
from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM as PortSfM
from tests.test_torch_config import port_config

KP = 128


def _cfg(**kw):
    return PipelineConfig(
        frontend=FrontendConfig(max_keypoints=KP, upsample_first_octave=False),
        matcher=MatcherConfig(ratio=0.9),
        capacity=CapacityConfig(max_views=8, max_keypoints=KP, max_points=1024,
                                max_observations=4096),
        **kw,
    )


def _video_with_duplicates(frames, jitter_px=0.2, repeats=2, seed=0):
    """Each real frame followed by ``repeats`` near-identical frames (the
    sequence of ``tests/test_keyframes.py``)."""
    rng = np.random.default_rng(seed)
    video, is_dup = [], []
    for xy, d, valid in frames:
        video.append((xy, d, valid))
        is_dup.append(False)
        for _ in range(repeats):
            jx = xy + rng.normal(size=xy.shape).astype(np.float32) * jitter_px
            video.append((jx.astype(np.float32), d, valid))
            is_dup.append(True)
    return video, is_dup


@pytest.fixture(scope="module")
def runs():
    K, frames, *_ = synthetic_sequence(n_views=4, n_points=100, kp_cap=KP)
    video, is_dup = _video_with_duplicates(frames)
    cfg = _cfg(keyframe_min_flow_px=3.0)
    jax_engine = JaxSfM(cfg, K, frontend="precomputed", seed=0)
    port_engine = PortSfM(port_config(cfg), K, frontend="precomputed", seed=0, device="cpu")
    infos = {"jax": [jax_engine.process_features(*f) for f in video],
             "port": [port_engine.process_features(*f) for f in video]}
    return dict(K=K, cfg=cfg, video=video, is_dup=is_dup, infos=infos, jax=jax_engine,
                port=port_engine)


def test_the_same_frames_are_skipped(runs):
    for name in ("jax", "port"):
        skipped = [bool(i.get("keyframe_skipped")) for i in runs["infos"][name]]
        assert skipped == runs["is_dup"], name
    for ij, ip in zip(runs["infos"]["jax"][1:], runs["infos"]["port"][1:]):
        assert ip["flow_px"] == pytest.approx(float(ij["flow_px"]), abs=1e-3)
        assert ip.get("input_index") == ij.get("input_index")
        assert ip["frame"] == ij["frame"]
    assert "flow_px" not in runs["infos"]["port"][0]


def test_bookkeeping_is_equal(runs):
    assert runs["port"].keyframe_indices == runs["jax"].keyframe_indices == [0, 3, 6, 9]
    assert runs["port"]._input_index == runs["jax"]._input_index == len(runs["video"])
    assert runs["port"]._frame == runs["jax"]._frame == 4
    assert len(runs["port"].poses()[0]) == 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bookkeeping_survives_a_checkpoint_both_ways(runs, tmp_path, writer):
    path = str(tmp_path / "state.npz")
    runs[writer].save_checkpoint(path)
    readers = {
        "jax": JaxSfM(runs["cfg"], runs["K"], frontend="precomputed", seed=0),
        "port": PortSfM(port_config(runs["cfg"]), runs["K"], frontend="precomputed", seed=0,
                        device="cpu"),
    }
    for name, engine in readers.items():
        assert engine.load_checkpoint(path) == 4, name
        assert engine.keyframe_indices == [0, 3, 6, 9], name
        assert engine._input_index == len(runs["video"]), name
    # a duplicate fed after the resume is still skipped, and counted
    info = readers["port"].process_features(*runs["video"][-1])
    assert info["keyframe_skipped"] and info["input_index"] == len(runs["video"])
    assert readers["port"]._input_index == len(runs["video"]) + 1


def test_zero_threshold_admits_everything_and_counts_inputs():
    K, frames, *_ = synthetic_sequence(n_views=3, n_points=60, kp_cap=KP)
    engine = PortSfM(port_config(_cfg()), K, frontend="precomputed", device="cpu")
    infos = [engine.process_features(*f) for f in frames]
    assert not any(i.get("keyframe_skipped") for i in infos)
    assert all("flow_px" not in i for i in infos)
    assert engine.keyframe_indices == [0, 1, 2] and engine._input_index == 3


def test_too_few_matches_admit_the_frame():
    """Fewer than 8 matches against the last accepted frame: the flow is
    +inf and the frame is admitted (a scene cut carries new content)."""
    K, frames, *_ = synthetic_sequence(n_views=2, n_points=60, kp_cap=KP)
    rng = np.random.default_rng(1)
    xy, d, valid = frames[1]
    cut = (xy, rng.normal(size=d.shape).astype(np.float32) * 10, valid)
    engine = PortSfM(port_config(_cfg(keyframe_min_flow_px=3.0)), K, frontend="precomputed",
                     device="cpu")
    engine.process_features(*frames[0])
    info = engine.process_features(*cut)
    assert not info.get("keyframe_skipped") and info["flow_px"] == float("inf")
    assert engine.keyframe_indices == [0, 1]


def test_process_image_accepts_tensors_on_the_engines_device_only():
    import torch

    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence

    imgs, K, *_ = synthetic_scene_sequence(1, (64, 96), seed=3)
    cfg = port_config(_cfg())
    got = []
    for img in (imgs[0], torch.from_numpy(np.asarray(imgs[0]))):
        engine = PortSfM(cfg, K, frontend="native", device="cpu")
        engine.process_image(img)
        got.append(engine.state.kp_xy[0].clone())
    assert torch.equal(*got)
    with pytest.raises(ValueError, match="the engine runs on"):
        engine.process_image(torch.empty(64, 96, device="meta"))
    kps, desc = engine.detect(imgs[0])
    assert torch.equal(kps.xy, got[0]) and desc.shape == (KP, 128)
