"""The port's incremental engine against the JAX engine on rendered frames.

Both engines see the same frames; the JAX engine runs on the CPU with its
Pallas kernels forced (interpret mode), the port on the CPU with its
kernels' plain versions. The BA stage is compared numerically on a shared
state; whole runs are compared as quality bands, because the two packages
draw different RANSAC hypotheses."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.config import (
    BAConfig,
    CapacityConfig,
    FrontendConfig,
    MatcherConfig,
    PipelineConfig,
    RansacConfig,
)
from structure_from_motion_tpu.io.synthetic import synthetic_scene_sequence
from structure_from_motion_tpu.models import IncrementalSfM as JaxSfM
from structure_from_motion_tpu.models import incremental as Ji
from structure_from_motion_tpu.models import tracks as Jtr
from structure_from_motion_tpu_torch.convert import state_from_numpy, state_to_numpy
from structure_from_motion_tpu_torch.models import incremental as Ti
from structure_from_motion_tpu_torch.models import tracks as Ttr
from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
from structure_from_motion_tpu_torch.utils import control
from tests.test_incremental import umeyama_ate
from tests.test_torch_config import port_config

# 4 frames with the per-frame motion of tests/test_synthetic_gt.py:77-79
# (loops 0.7 over 10 frames = 0.07 per frame)
FRAMES = dict(n_frames=4, size=(256, 384), seed=3, loops=0.28)


# the JAX side pinned to its accelerator semantics (Pallas kernels, f32
# extremum windows); the port reads none of the impl fields
CONFIG = PipelineConfig(
    frontend=FrontendConfig(max_keypoints=256, num_octaves=2, blur_impl="pallas",
                            extrema_impl="pallas", extrema_dtype="f32"),
    matcher=MatcherConfig(ratio=0.75, use_fundamental_gate=True, impl="pallas",
                          gate_ransac=RansacConfig(inlier_threshold=3.0, iteration=128)),
    ba=BAConfig(huber_delta=0.01, assemble_impl="pallas"),
    capacity=CapacityConfig(max_views=8, max_keypoints=256, max_points=2048,
                            max_observations=8192),
    window_size=8,
)


@pytest.fixture(scope="module")
def runs():
    """The JAX engine over the 4 frames (its state after frame 3 kept) and
    the port's engine over the same frames."""
    imgs, K, C_gt, _ = synthetic_scene_sequence(**FRAMES)
    jeng = JaxSfM(CONFIG, K, frontend="native", seed=0)
    after3 = None
    for f, im in enumerate(imgs):
        jeng.process_image(im)
        if f == 2:
            after3 = {k: np.asarray(v) for k, v in jax.device_get(jeng.state)._asdict().items()}
    teng = IncrementalSfM(port_config(CONFIG), K, frontend="native", seed=0, device="cpu")
    for im in imgs:
        teng.process_image(im)
    return dict(jax=jeng, port=teng, after3=after3, C_gt=C_gt)


def test_ba_stage_matches_jax_on_a_shared_state(runs):
    """The JAX state after 3 frames, carried across with state_from_numpy:
    both packages' BA stage (bucketed LM, Huber, dense Schur solve, pruning)
    give per-iteration costs to rtol 1e-4 and poses/points to atol 1e-4."""
    snap = runs["after3"]
    cfg = CONFIG
    st = state_from_numpy(snap, "cpu")
    back = state_to_numpy(st)
    for k, v in snap.items():
        np.testing.assert_array_equal(back[k], v.astype(back[k].dtype))
    j_state = Jtr.SfMState(**{k: jnp.asarray(v) for k, v in snap.items()})
    jo, jcost, _, jpo, jpp = Ji._ba_stage(j_state, config=cfg)
    to, tcost, _, tpo, tpp = Ti._ba_stage(st, port_config(cfg))
    np.testing.assert_allclose(tcost.numpy(), np.asarray(jcost), rtol=1e-4)
    assert (int(tpo), int(tpp)) == (int(jpo), int(jpp))
    np.testing.assert_array_equal(to.pt_valid.numpy(), np.asarray(jo.pt_valid))
    for name in ("cam_C", "cam_q", "points"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   atol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def device_form_port():
    """The port's engine over the 4 frames in ``control.device_form``: its
    steady frames as the card's CUDA graph runs them (every bucket's branch
    run and the indexed one kept, every loop chunk run, no host read)."""
    imgs, K, _, _ = synthetic_scene_sequence(**FRAMES)
    teng = IncrementalSfM(port_config(CONFIG), K, frontend="native", seed=0, device="cpu")
    with control.device_form():
        for im in imgs:
            teng.process_image(im)
    return teng


@pytest.mark.parametrize("form", ["eager", "device"])
def test_whole_slice_matches_jax_quality(runs, form, request):
    """Both engines reproject under 2 px and the port's camera centres lie
    within 5% of the span of the JAX centres after similarity alignment;
    the port run eagerly and in the graph's device form."""
    jeng = runs["jax"]
    teng = runs["port"] if form == "eager" else request.getfixturevalue("device_form_port")
    assert jeng.reprojection_error() < 2.0
    assert teng.reprojection_error() < 2.0
    jl, _ = jeng.poses()
    tl, tr = teng.poses()
    assert tl.shape == (4, 3) and tr.shape == (4, 3, 3)
    span = float(np.linalg.norm(jl.max(0) - jl.min(0)))
    assert umeyama_ate(tl, jl) / span < 0.05
    assert len(teng.map_points()) > 100


def test_capacity_overflow_is_counted_like_jax():
    """Appending past the point and observation capacities drops and counts
    the overflow (no index error), exactly as the JAX store does."""
    cap = CapacityConfig(max_views=2, max_keypoints=8, max_points=6, max_observations=10)
    K = np.eye(3, dtype=np.float32)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(8, 3)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 1, 1], bool)
    uv = rng.normal(size=(8, 2)).astype(np.float32)
    keys = np.arange(8, dtype=np.int32)

    def run(tr, arr, st):
        for _ in range(2):
            st, ids, stored = tr.allocate_points(st, arr(X), arr(mask))
            st = tr.set_tri_index(st, 1, arr(keys), ids, stored)
            st = tr.append_observations(st, ids * 0 + 1, ids, arr(uv), stored)
        return st

    js = run(Jtr, jnp.asarray, Jtr.init_state(cap, K))
    ts = run(Ttr, torch.as_tensor, Ttr.init_state(port_config(cap), K, device="cpu"))
    jd = {k: np.asarray(v) for k, v in js._asdict().items()}
    for k, v in state_to_numpy(ts).items():
        np.testing.assert_array_equal(v, jd[k].astype(v.dtype), err_msg=k)
    assert int(ts.dropped_points) > 0


@pytest.mark.parametrize("count", [0, 2048, 2049, 4096, 4097, 8192, 8193, 32768])
def test_localize_bucket_matches_jax(count):
    """The host-side bucket choice picks the rung JAX's on-device
    ``lax.switch`` index picks, on the slice's V*K = 16 x 2048 ladder."""
    ladder = Ti._bucket_ladder(16 * 2048, floor=2048)
    assert ladder == Ji._bucket_ladder(16 * 2048, floor=2048)
    want = ladder[int(Ji._bucket_index(jnp.asarray(count), ladder))]
    assert Ti._bucket_size(count, ladder) == want


@pytest.mark.parametrize("n_pts,n_obs", [(0, 0), (2048, 8192), (2049, 100), (100, 8193),
                                         (4096, 16384), (16384, 65536)])
def test_ba_bucket_matches_jax(n_pts, n_obs):
    ladder = Ti._ba_ladder(16384, 65536)
    assert ladder == Ji._ba_ladder(16384, 65536)
    want = ladder[int(Ji._ba_bucket_index(ladder, jnp.asarray(n_pts), jnp.asarray(n_obs)))]
    assert Ti._ba_bucket(ladder, n_pts, n_obs) == want


def test_pack_indices_matches_jax():
    """Valid entries first in original order, then the masked leftovers by
    ascending index (lax.top_k's tie rule on the zero scores)."""
    mask = np.random.default_rng(1).random(4096) < 0.3
    want = np.asarray(Ji._pack_indices(jnp.asarray(mask), 2048))
    np.testing.assert_array_equal(Ti._pack_indices(torch.as_tensor(mask), 2048).numpy(), want)


def test_port_import_leaves_jax_unloaded():
    code = (
        "import sys; import structure_from_motion_tpu_torch.models.incremental, "
        "structure_from_motion_tpu_torch.models.global_ba, "
        "structure_from_motion_tpu_torch.utils.checkpoint, "
        "structure_from_motion_tpu_torch.convert; "
        "assert 'jax' not in sys.modules, 'jax imported'"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.slow
def test_exact_gt_trajectory_native_frontend_port():
    """Port twin of tests/test_synthetic_gt.py::
    test_exact_gt_trajectory_native_frontend: 10 rendered frames through the
    port's native pipeline; ATE against the exact truth < 5% of span and
    mean reprojection < 2 px."""
    from structure_from_motion_tpu.config import LMConfig

    cfg = PipelineConfig(
        frontend=FrontendConfig(max_keypoints=512, upsample_first_octave=False),
        matcher=MatcherConfig(ratio=0.85),
        fundamental_ransac=RansacConfig(inlier_threshold=2.0, iteration=256),
        pnp_ransac=RansacConfig(inlier_threshold=8.0, sample_num=6, iteration=512),
        pnp_lm=LMConfig(damping=5.0, iterations=100),
        triangulation_lm=LMConfig(damping=5.0, iterations=50),
        ba=BAConfig(iterations=5, damping=5.0, huber_delta=0.01),
        capacity=CapacityConfig(max_views=10, max_keypoints=512, max_points=4096,
                                max_observations=16384),
        prune_max_error_px=8.0,
    )
    imgs, K, C_gt, _ = synthetic_scene_sequence(n_frames=10, size=(240, 320), seed=3, loops=0.7)
    engine = IncrementalSfM(port_config(cfg), K, frontend="native", seed=0, device="cpu")
    for im in imgs:
        info = engine.process_image(im)
    assert not info.get("skipped")
    locs, _ = engine.poses()
    assert locs.shape == (10, 3)
    span = float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))
    assert umeyama_ate(locs, C_gt) / span < 0.05
    assert engine.reprojection_error() < 2.0
