"""The port's batched lockstep engine and the lane axis of its kernels.

Twins of ``tests/test_batched.py`` (B lanes on precomputed features, ATE and
map size; slide mode against single-sequence runs with the same seeds),
lane b of the batched engine against the port's single engine with seed
s_b (atol 5e-3, the JAX test's), the refusals, the three shapes of K, and
each kernel's plain version with a lane axis: equal to its one-lane
version stacked, and to the JAX ``vmap`` of the interpreted Pallas kernel
at B = 2. The engine runs with ``torch.func.vmap`` fallbacks turned into
errors: a fallback is a hidden loop over lanes."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.config import (
    BAConfig,
    CapacityConfig,
    FrontendConfig,
    LMConfig,
    MatcherConfig,
    PipelineConfig,
    RansacConfig,
)
from structure_from_motion_tpu.ops import features as JF
from structure_from_motion_tpu.ops.ba_pallas import pallas_ba_blocks
from structure_from_motion_tpu.ops.blur_pallas import pallas_blur_levels
from structure_from_motion_tpu.ops.features_pallas import pallas_candidate_response
from structure_from_motion_tpu.ops.matching import pallas_match_top2
from structure_from_motion_tpu_torch.io.synthetic import synthetic_sequence
from structure_from_motion_tpu_torch.models.batched import BatchedIncrementalSfM
from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
from structure_from_motion_tpu_torch.ops import ba_cuda, blur_cuda, features_cuda, matching
from structure_from_motion_tpu_torch.utils.debug import validate_state
from tests.test_incremental import umeyama_ate
from tests.test_torch_config import port_config

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(kp=512, **kw):
    """``tests/test_incremental.py``'s pipeline_config (``kp`` keypoints)."""
    return port_config(PipelineConfig(
        frontend=FrontendConfig(max_keypoints=kp, upsample_first_octave=False),
        matcher=MatcherConfig(ratio=0.9),
        fundamental_ransac=RansacConfig(inlier_threshold=2.0, iteration=256),
        pnp_ransac=RansacConfig(inlier_threshold=8.0, sample_num=6, iteration=512),
        pnp_lm=LMConfig(damping=5.0, iterations=100),
        triangulation_lm=LMConfig(damping=5.0, iterations=50),
        ba=BAConfig(iterations=5, damping=5.0),
        capacity=CapacityConfig(max_views=8, max_keypoints=kp, max_points=4096,
                                max_observations=16384),
        **kw,
    ))


@pytest.fixture(autouse=True)
def _no_vmap_fallback():
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield


def _run(eng, seqs, n):
    infos = []
    for t in range(n):
        infos.append(eng.process_features(*(np.stack([s[1][t][i] for s in seqs])
                                            for i in range(3))))
    return infos


def _single(cfg, K, frames, seed, n):
    eng = IncrementalSfM(cfg, K, frontend="precomputed", seed=seed, device="cpu")
    for f in frames[:n]:
        eng.process_features(*f)
    return eng


def test_batched_matches_single():
    """Twin of ``tests/test_batched.py::test_batched_matches_single``: B = 3
    lanes of 4 views, each lane's ATE < 0.05 and > 200 map points; and lane
    b equals the port's single engine with seed b (atol 5e-3)."""
    B, n = 3, 4
    cfg = _cfg()
    seqs = [synthetic_sequence(n_views=n, seed=s) for s in range(B)]
    K = seqs[0][0]
    eng = BatchedIncrementalSfM(cfg, K, batch=B, frontend="precomputed", device="cpu")
    infos = _run(eng, seqs, n)
    locs, rots = eng.poses()
    assert locs.shape == (B, n, 3) and rots.shape == (B, n, 3, 3)
    assert infos[-1]["reprojection_px"].shape == (B,)
    for b in range(B):
        assert umeyama_ate(locs[b], seqs[b][2][:n]) < 0.05
        assert len(eng.map_points(b)) > 200
        single = _single(cfg, K, seqs[b][1], b, n)
        s_locs, s_rots = single.poses()
        np.testing.assert_allclose(locs[b], s_locs, atol=5e-3)
        np.testing.assert_allclose(rots[b], s_rots, atol=5e-3)
        assert len(eng.map_points(b)) == len(single.map_points())
    assert validate_state(eng.state) == []


def _slide(n_frames, window, kp):
    B = 2
    base = _cfg(kp)
    cfg = dataclasses.replace(base, window_mode="slide", window_size=window,
                              capacity=dataclasses.replace(base.capacity, max_views=window))
    seqs = [synthetic_sequence(n_views=n_frames, seed=10 + s, kp_cap=kp, n_points=min(300, kp))
            for s in range(B)]
    K = seqs[0][0]
    eng = BatchedIncrementalSfM(cfg, K, batch=B, frontend="precomputed", seed=[7, 8],
                                device="cpu")
    _run(eng, seqs, n_frames)
    locs, rots = eng.poses()
    assert locs.shape == (B, n_frames, 3)
    assert len(eng._archive) == n_frames - window
    for b in range(B):
        single = _single(cfg, K, seqs[b][1], 7 + b, n_frames)
        s_locs, s_rots = single.poses()
        np.testing.assert_allclose(locs[b], s_locs, atol=5e-3)
        np.testing.assert_allclose(rots[b], s_rots, atol=5e-3)
        assert umeyama_ate(locs[b], seqs[b][2]) < 0.05
    assert validate_state(eng.state) == []


@pytest.mark.slow
def test_batched_slide_matches_single():
    """Twin of ``tests/test_batched.py::test_batched_slide_matches_single``:
    6 frames through a window of 4, B = 2, seeds 7 and 8; every lane evicts
    in lockstep and equals the single engine's whole trajectory."""
    _slide(6, 4, 512)


def test_batched_slide_matches_single_cheap():
    """The cheap twin: 5 frames through a window of 4 (one eviction), 128
    keypoints."""
    _slide(5, 4, 128)


def test_batched_refuses_keyframing_and_shards():
    """Twin of ``tests/test_keyframes.py::test_batched_engine_rejects_keyframing``,
    and the refusal of sharded BA."""
    K = np.eye(3)
    with pytest.raises(NotImplementedError):
        BatchedIncrementalSfM(_cfg(keyframe_min_flow_px=2.0), K, batch=2, device="cpu")
    with pytest.raises(NotImplementedError):
        BatchedIncrementalSfM(_cfg(ba_num_shards=2), K, batch=2, device="cpu")
    with pytest.raises(ValueError, match="seed"):
        BatchedIncrementalSfM(_cfg(), K, batch=2, seed=[1, 2, 3], device="cpu")


def test_K_shapes_give_the_same_state():
    """K as (3, 3), (B, 3, 3) and (B, V, 3, 3) of one matrix: the same
    state bit for bit after 3 frames; a per-lane (B, 3, 3) K of two
    different matrices is stored lane by lane."""
    B, n = 2, 3
    cfg = _cfg(128)
    seqs = [synthetic_sequence(n_views=n, seed=s, kp_cap=128, n_points=120) for s in range(B)]
    K = seqs[0][0].astype(np.float32)
    V = cfg.capacity.max_views
    states = []
    for Kin in (K, np.broadcast_to(K, (B, 3, 3)), np.broadcast_to(K, (B, V, 3, 3))):
        eng = BatchedIncrementalSfM(cfg, Kin, batch=B, frontend="precomputed", device="cpu")
        _run(eng, seqs, n)
        states.append(eng.state)
    for other in states[1:]:
        for a, b in zip(states[0], other):
            assert torch.equal(a, b)
    K2 = np.stack([K, K * np.float32([[1.1], [1.1], [1.0]])])
    eng = BatchedIncrementalSfM(cfg, K2, batch=B, frontend="precomputed", device="cpu")
    np.testing.assert_array_equal(eng.state.K[:, 3].numpy(), K2)


def test_per_lane_K_lane_matches_its_single_run():
    """Per-lane intrinsics (B, 3, 3): lane b, fed features projected with
    its own K, equals the single engine given that K (atol 5e-3)."""
    B, n = 2, 4
    cfg = _cfg(128)
    seqs, Ks = [], []
    for b in range(B):
        f = 500.0 * (1.0 + 0.2 * b)
        Kb = np.array([[f, 0, 320.0], [0, f, 240.0], [0, 0, 1.0]])
        K0, frames, C_gt, *_ = synthetic_sequence(n_views=n, seed=20 + b, kp_cap=128,
                                                  n_points=120)
        # re-project the same geometry through K_b: normalised coords are K-free
        frames = [(np.where(v[:, None], (xy - K0[:2, 2]) / K0[0, 0] * f + Kb[:2, 2], 0)
                   .astype(np.float32), d, v) for xy, d, v in frames]
        seqs.append((Kb, frames, C_gt))
        Ks.append(Kb)
    eng = BatchedIncrementalSfM(cfg, np.stack(Ks), batch=B, frontend="precomputed",
                                device="cpu")
    _run(eng, seqs, n)
    locs, _ = eng.poses()
    for b in range(B):
        s_locs, _ = _single(cfg, Ks[b], seqs[b][1], b, n).poses()
        np.testing.assert_allclose(locs[b], s_locs, atol=5e-3)
        assert umeyama_ate(locs[b], seqs[b][2]) < 0.05


def test_distortion_lanes_match_single():
    """With ``config.distortion`` every lane undistorts at ingest (vmapped
    over lanes) and equals its single run (atol 5e-3)."""
    cfg = dataclasses.replace(_cfg(128), distortion=(-0.05, 0.01))
    seqs = [synthetic_sequence(n_views=3, seed=s, kp_cap=128, n_points=120) for s in range(2)]
    K = seqs[0][0]
    eng = BatchedIncrementalSfM(cfg, K, batch=2, frontend="precomputed", device="cpu")
    _run(eng, seqs, 3)
    locs, _ = eng.poses()
    for b in range(2):
        np.testing.assert_allclose(locs[b], _single(cfg, K, seqs[b][1], b, 3).poses()[0],
                                   atol=5e-3)


def test_process_images_lanes_match_single():
    """The native frontend with a lane axis: 2 lanes of 3 rendered 120x160
    frames each; the lanes' valid keypoints and descriptors equal each
    image's own detection bit for bit (a masked padding row may read other
    taps at the end of the flat pyramid), and each lane's poses equal its
    single run's (atol 5e-3)."""
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence
    from structure_from_motion_tpu_torch.ops.features import detect_and_describe

    cfg = port_config(PipelineConfig(
        frontend=FrontendConfig(max_keypoints=128, num_octaves=2, upsample_first_octave=False),
        capacity=CapacityConfig(max_views=4, max_keypoints=128, max_points=1024,
                                max_observations=4096)))
    seqs = [synthetic_scene_sequence(3, (120, 160), seed=3 + b, loops=0.21) for b in range(2)]
    K = seqs[0][1]
    stack = np.stack([s[0][0] for s in seqs]).astype(np.float32)
    kl, dl = detect_and_describe(T(stack), cfg.frontend)
    for b in range(2):
        k1, d1 = detect_and_describe(T(stack[b]), cfg.frontend)
        m = k1.mask
        assert torch.equal(kl.mask[b], m) and int(m.sum()) > 40
        for a, c in zip(kl, k1):
            assert torch.equal(a[b][m], c[m])
        assert torch.equal(dl[b], d1)
    eng = BatchedIncrementalSfM(cfg, K, batch=2, seed=[5, 6], device="cpu")
    for t in range(3):
        eng.process_images(np.stack([s[0][t] for s in seqs]))
    locs, _ = eng.poses()
    for b in range(2):
        single = IncrementalSfM(cfg, K, frontend="native", seed=5 + b, device="cpu")
        for im in seqs[b][0]:
            single.process_image(im)
        np.testing.assert_allclose(locs[b], single.poses()[0], atol=5e-3)


# -- the kernels' plain versions with a lane axis --------------------------------

def test_blur_lanes_plain_is_one_lane_stacked_and_matches_vmapped_pallas():
    """B1 plain version on (2, H, W): equal to the (H, W) version stacked,
    and to the JAX vmap of the interpreted Pallas blur (atol 2e-5)."""
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 32, 128)).astype(np.float32)
    ks = [JF._gaussian_kernel1d(s) for s in (1.2, 2.5)]
    got = blur_cuda.blur_levels_reference(T(img), ks)
    assert got.shape == (2, 2, 32, 128)
    for b in range(2):
        assert torch.equal(got[b], blur_cuda.blur_levels_reference(T(img[b]), ks))
    want = np.asarray(jax.vmap(lambda x: pallas_blur_levels(x, ks, interpret=True))(
        jnp.asarray(img)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_candidate_lanes_plain_is_one_lane_stacked_and_matches_vmapped_pallas():
    """B2 (map and fused) plain versions on (2, S+2, H, W): equal to the
    one-lane versions stacked; the map bit for bit equal to the JAX vmap of
    the interpreted Pallas kernel."""
    rng = np.random.default_rng(6)
    dog = (rng.normal(size=(2, 5, 32, 128)) * 0.05).astype(np.float32)
    resp = features_cuda.candidate_response_reference(T(dog), 0.015, 10.0, 8)
    cand, pos = features_cuda.candidate_block_max_reference(T(dog), 0.015, 10.0, 8)
    assert resp.shape == (2, 3, 32, 128) and cand.shape == pos.shape == (2, 3, 4, 16)
    for b in range(2):
        assert torch.equal(resp[b], features_cuda.candidate_response_reference(
            T(dog[b]), 0.015, 10.0, 8))
        c1, p1 = features_cuda.candidate_block_max_reference(T(dog[b]), 0.015, 10.0, 8)
        assert torch.equal(cand[b], c1) and torch.equal(pos[b], p1)
    want = np.asarray(jax.vmap(lambda d: pallas_candidate_response(
        d, 0.015, 10.0, border=8, interpret=True))(jnp.asarray(dog)))
    assert (want > 0).sum() > 20
    np.testing.assert_array_equal(resp.numpy(), want)


def test_match_top2_lanes_plain_matches_one_lane_and_vmapped_pallas():
    """B3 plain version with lanes: lane b's rows meet lane b's queries only.
    d^2 within rtol 1e-5 of the one-lane version and of the JAX vmap of the
    interpreted Pallas kernel (atol 1e-4 on unit rows), j1 equal."""
    rng = np.random.default_rng(7)

    def unit(n):
        d = np.abs(rng.normal(size=(2, n, 128))).astype(np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    ref, que = unit(256), unit(512)
    mq = rng.random((2, 512)) < 0.9
    d1, d2, j1 = matching.match_top2_reference(T(ref), T(que), T(mq))
    for b in range(2):
        s1, s2, sj = matching.match_top2_reference(T(ref[b]), T(que[b]), T(mq[b]))
        np.testing.assert_allclose(d1[b].numpy(), s1.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(d2[b].numpy(), s2.numpy(), rtol=1e-5, atol=1e-6)
        assert torch.equal(j1[b], sj)
    w1, w2, wj = jax.vmap(lambda r, q, m: pallas_match_top2(r, q, m, interpret=True))(
        jnp.asarray(ref), jnp.asarray(que), jnp.asarray(mq))
    np.testing.assert_allclose(d1.numpy(), np.asarray(w1), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(d2.numpy(), np.asarray(w2), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(j1.numpy(), np.asarray(wj))


def test_match_descriptors_with_lanes_equals_each_lane_alone():
    """The matcher with a lane axis (B, G, Nr, D) x (B, Nq, D): each lane's
    result equals the one-lane call, for L2, Hamming and cross-check."""
    rng = np.random.default_rng(8)
    ref = rng.normal(size=(2, 3, 64, 128)).astype(np.float32)
    que = np.concatenate([ref[:, 1, :40] + 0.05 * rng.normal(size=(2, 40, 128)),
                          rng.normal(size=(2, 24, 128))], axis=1).astype(np.float32)
    mr, mq = rng.random((2, 3, 64)) < 0.9, rng.random((2, 64)) < 0.9
    for cfg in (MatcherConfig(ratio=0.8), MatcherConfig(ratio=0.95, cross_check=True),
                MatcherConfig(ratio=0.95, metric="hamming", cross_check=True)):
        r, q = (np.sign(ref), np.sign(que)) if cfg.metric == "hamming" else (ref, que)
        got = matching.match_descriptors(T(r), T(q), T(mr), T(mq), port_config(cfg))
        for b in range(2):
            one = matching.match_descriptors(T(r[b]), T(q[b]), T(mr[b]), T(mq[b]),
                                             port_config(cfg))
            assert torch.equal(got.valid[b], one.valid)
            assert torch.equal(got.target[b], one.target)
        assert int(got.valid.sum()) > 40


def test_ba_blocks_lanes_plain_matches_one_lane_and_vmapped_pallas():
    """B4 plain version on (2, O) observations: each lane equals its own
    call (rtol 1e-5), and the JAX vmap of the interpreted Pallas kernel to
    1e-3 x max(1, |value|), the tolerance the one-lane test holds."""
    rng = np.random.default_rng(9)
    B, O, V = 2, 512, 4
    cam = rng.integers(0, V, (B, O)).astype(np.int32)
    C = rng.normal(size=(B, O, 3)).astype(np.float32) * 0.1
    q = (np.float32([1, 0, 0, 0]) + 0.05 * rng.normal(size=(B, O, 4))).astype(np.float32)
    X = (rng.normal(size=(B, O, 3)) + [0, 0, 8]).astype(np.float32)
    uv = (0.1 * rng.normal(size=(B, O, 2))).astype(np.float32)
    w = (rng.random((B, O)) < 0.8).astype(np.float32)
    got = ba_cuda.ba_blocks_reference(T(cam), T(C), T(q), T(X), T(uv), T(w), V, 0.01)
    assert got[0].shape == (B, V, 7, 7) and got[5].shape == (B,)
    for b in range(B):
        one = ba_cuda.ba_blocks_reference(T(cam[b]), T(C[b]), T(q[b]), T(X[b]), T(uv[b]),
                                          T(w[b]), V, 0.01)
        for a, c in zip(got, one):
            np.testing.assert_allclose(a[b].numpy(), c.numpy(), rtol=1e-5, atol=1e-6)
    want = jax.vmap(lambda *a: pallas_ba_blocks(*a, V, 0.01, interpret=True))(
        *(jnp.asarray(a) for a in (cam, C, q, X, uv, w)))
    names = ("U", "b_c", "DtD", "W", "b_p", "cost")
    for name, a, c in zip(names, got, want):
        c = np.asarray(c, np.float32)
        assert np.abs(a.numpy().reshape(c.shape) - c).max() <= 1e-3 * max(1.0, np.abs(c).max()), \
            name


# -- one copy of the stage code: lane stacks against each lane alone -------------

def _store(seed, cap):
    """A small store with points, observations of 3 views and matches."""
    from structure_from_motion_tpu_torch.models import tracks

    rng = np.random.default_rng(seed)
    st = tracks.init_state(cap, np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]]),
                           desc_dim=8, device="cpu")
    for v in range(3):
        st = tracks.set_camera(st, v, T(rng.normal(size=3).astype(np.float32) * 0.1),
                               torch.tensor([1.0, 0, 0, 0]))
    n = 10
    X = T((rng.normal(size=(n, 3)) + [0, 0, 6]).astype(np.float32))
    st, ids, stored = tracks.allocate_points(st, X, T(rng.random(n) < 0.8))
    for v in range(3):
        uv = T((32 + 100 * rng.normal(size=(n, 2)) * 0.02).astype(np.float32))
        keep = stored & T(rng.random(n) < 0.9)
        st = tracks.append_observations(st, torch.full((n,), v, dtype=torch.int32), ids, uv,
                                        keep)
        st = tracks.set_tri_index(st, v, torch.arange(n, dtype=torch.int32), ids, keep)
    return st


def test_track_helpers_on_a_lane_stack_equal_each_lane_alone():
    """The store helpers are one copy, written for a lane stack: on a stack
    of two different stores, every lane of the result equals the helper on
    that store alone, bit for bit (eviction, pruning, allocation past the
    capacity, the reprojection metric)."""
    from structure_from_motion_tpu_torch.config import CapacityConfig as TCap
    from structure_from_motion_tpu_torch.models import tracks

    cap = TCap(max_views=4, max_keypoints=12, max_points=14, max_observations=40)
    one = [_store(s, cap) for s in (1, 2)]
    stack = tracks.SfMState(*(torch.stack(f) for f in zip(*one)))
    X = T(np.random.default_rng(3).normal(size=(2, 6, 3)).astype(np.float32))
    mask = T(np.array([[1, 1, 0, 1, 1, 1], [1, 0, 1, 1, 1, 1]], bool))
    cases = [
        (lambda st, b: tracks.evict_oldest_view(st)),
        (lambda st, b: tracks.prune_observations(st, 4.0)),
        (lambda st, b: tracks.allocate_points(st, X if b is None else X[b],
                                              mask if b is None else mask[b])),
        (lambda st, b: (tracks.reprojection_error(st),)),
    ]
    for fn in cases:
        got = fn(stack, None)
        for b in range(2):
            want = fn(one[b], b)
            for g, w in zip(got, want):
                g = tracks.lane_state(g, b) if isinstance(g, tuple) else g[b]
                for x, y in zip(g if isinstance(g, tuple) else (g,),
                                w if isinstance(w, tuple) else (w,)):
                    assert torch.equal(x, y)
    assert int(stack.num_points.max()) > 0 and int(stack.num_obs.min()) > 10


def test_pnp_on_lanes_equals_each_lane_alone():
    """``estimate_pnp`` with one generator a lane over (B, N, ...) inputs:
    each lane's pose equals the call on that lane alone with its generator
    (atol 1e-5; the LM loops stop lane by lane) and its inliers are equal."""
    from structure_from_motion_tpu_torch.config import LMConfig as TLM
    from structure_from_motion_tpu_torch.config import RansacConfig as TRc
    from structure_from_motion_tpu_torch.device import generator
    from structure_from_motion_tpu_torch.ops.pnp import estimate_pnp
    from structure_from_motion_tpu_torch.utils.rotations import quat_to_rotation

    rng = np.random.default_rng(11)
    B, N = 3, 300
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    Xs, uvs, Cs = [], [], []
    for b in range(B):
        X = (rng.normal(size=(N, 3)) * [2, 2, 1] + [0, 0, 8]).astype(np.float32)
        C = (0.3 * rng.normal(size=3)).astype(np.float32)
        R = quat_to_rotation(T((np.float32([1, 0, 0, 0]) + 0.05 * rng.normal(size=4))
                               .astype(np.float32))).numpy()
        x = (X - C) @ R  # R^T (X - C)
        uv = x[:, :2] / x[:, 2:] * 500.0 + [320, 240] + rng.normal(size=(N, 2)) * 0.5
        uv[: N // 5] += rng.normal(size=(N // 5, 2)) * 60  # outliers
        Xs.append(X), uvs.append(uv.astype(np.float32)), Cs.append(C)
    X, uv = T(np.stack(Xs)), T(np.stack(uvs))
    Kb = T(np.broadcast_to(K, (B, 3, 3)).copy())
    mask = T(rng.random((B, N)) < 0.95)
    rc, lm = TRc(inlier_threshold=4.0, iteration=64), TLM(damping=1e-3, iterations=30)
    gens = [generator(torch.device("cpu"), 7 + b, 3, 1) for b in range(B)]
    got = estimate_pnp(gens, X, uv, Kb, mask, rc, lm)
    assert got.R.shape == (B, 3, 3) and got.inliers.shape == (B, N)
    for b in range(B):
        one = estimate_pnp(generator(torch.device("cpu"), 7 + b, 3, 1), X[b], uv[b], T(K),
                           mask[b], rc, lm)
        np.testing.assert_allclose(got.C[b].numpy(), one.C.numpy(), atol=1e-5)
        np.testing.assert_allclose(got.R[b].numpy(), one.R.numpy(), atol=1e-5)
        assert torch.equal(got.inliers[b], one.inliers)
        np.testing.assert_allclose(one.C.numpy(), Cs[b], atol=0.05)


def test_ba_on_lanes_pads_odd_streams_and_equals_each_lane_alone():
    """The per-frame BA over a lane stack whose ELL stream is not a multiple
    of 4 observations (5 points x 3 slots): each lane's stream is padded
    with empty slots to one (kernel B4 takes a lane stack in rows of 4),
    and each lane's result equals the call on its problem alone (atol
    1e-5, costs rtol 1e-5)."""
    from structure_from_motion_tpu_torch.config import BAConfig as TBA
    from structure_from_motion_tpu_torch.ops import ba as Tba

    rng = np.random.default_rng(12)
    B, V, M = 2, 3, 5
    states, obss = [], []
    for b in range(B):
        C = T((0.5 * rng.normal(size=(V, 3))).astype(np.float32))
        q = T(np.tile(np.float32([1, 0, 0, 0]), (V, 1)))
        Xw = (rng.normal(size=(M, 3)) + [0, 0, 6]).astype(np.float32)
        cam = np.repeat(np.arange(V), M).astype(np.int32)
        pt = np.tile(np.arange(M), V).astype(np.int32)
        d = Xw[pt] - C.numpy()[cam]
        uvn = (d[:, :2] / d[:, 2:] + 0.01 * rng.normal(size=(V * M, 2))).astype(np.float32)
        X = T(Xw + 0.05 * rng.normal(size=(M, 3)).astype(np.float32))
        states.append(Tba.BAState(C=C, q=q, X=X, cam_valid=torch.ones(V, dtype=torch.bool),
                                  pt_valid=torch.ones(M, dtype=torch.bool)))
        obss.append(Tba.BAObservations(cam=T(cam), point=T(pt), uv_norm=T(uvn),
                                       valid=T(rng.random(V * M) < 0.9)))
    stack = Tba.BAState(*(torch.stack(f) for f in zip(*states)))
    obs = Tba.BAObservations(*(torch.stack(f) for f in zip(*obss)))
    cfg = TBA(iterations=4, damping=1e-3)
    packed, lay = Tba._layout(stack, obs, cfg)
    assert packed.cam.shape == (B, 16) and lay.pad == 1 and lay.lanes == B
    out, costs = Tba.run_bundle_adjustment(stack, obs, cfg)
    assert costs.shape == (B, 4)
    for b in range(B):
        one, c1 = Tba.run_bundle_adjustment(states[b], obss[b], cfg)
        np.testing.assert_allclose(costs[b].numpy(), c1.numpy(), rtol=1e-5)
        for name in ("C", "q", "X"):
            np.testing.assert_allclose(getattr(out, name)[b].numpy(),
                                       getattr(one, name).numpy(), atol=1e-5)
    assert float(costs[0, -1]) < float(costs[0, 0])
