"""The port's slide mode, eviction archive, checkpoints and whole-trajectory
global BA against the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU: the
JAX side with its Pallas matvec kernels in interpret mode where a test says
so, the port with its kernels' plain versions. Each test states its
tolerance."""

import copy
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.config import BAConfig, CapacityConfig, FrontendConfig
from structure_from_motion_tpu.models import IncrementalSfM as JaxSfM
from structure_from_motion_tpu.models import global_ba as Jg
from structure_from_motion_tpu.models import tracks as Jtr
from structure_from_motion_tpu.ops import ba as Jba
from structure_from_motion_tpu.ops.linalg import pcg_solve as jax_pcg_solve
from structure_from_motion_tpu.ops.reproj import batched_residual_jacobians
from structure_from_motion_tpu.utils import checkpoint as Jck
from structure_from_motion_tpu.utils.rotations import rotation_to_quat
from structure_from_motion_tpu_torch.convert import (
    archive_from_numpy,
    archive_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from structure_from_motion_tpu_torch.models import global_ba as Tg
from structure_from_motion_tpu_torch.models import tracks as Ttr
from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
from structure_from_motion_tpu_torch.ops import ba as Tba
from structure_from_motion_tpu_torch.ops.linalg import pcg_solve
from structure_from_motion_tpu_torch.utils import checkpoint as Tck
from tests.test_torch_config import port_config
from tests.test_incremental import (
    pipeline_config,  # noqa: F401  (fixture)
    synthetic_sequence,
    umeyama_ate,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "longrun500_pre_globalba.ckpt.npz")
T = torch.from_numpy


def _np(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


# -- pcg_solve -----------------------------------------------------------------


@pytest.mark.parametrize("cap", [5, 200])
def test_pcg_solve_matches_jax(cap):
    """Block-Jacobi PCG on a seeded SPD (V, 7) block system (f64): the
    iterate matches JAX's while_loop to rtol 1e-5, and so does the stop
    point — with the cap binding (5) and with the early exit (200): JAX
    capped at the port's count returns its uncapped iterate, one step
    fewer does not."""
    rng = np.random.default_rng(0)
    V = 30
    B = rng.normal(size=(7 * V, 7 * V))
    A = B @ B.T / (7 * V) + np.diag(rng.uniform(0.05, 5.0, 7 * V))
    b = rng.normal(size=(V, 7))
    blocks = np.stack([A[7 * v:7 * v + 7, 7 * v:7 * v + 7] for v in range(V)])
    Pinv = np.linalg.inv(blocks)

    def jax_solve(n):
        Aj, Pj = jnp.asarray(A), jnp.asarray(Pinv)
        return np.asarray(jax_pcg_solve(
            lambda x: (Aj @ x.reshape(-1)).reshape(V, 7), jnp.asarray(b), n,
            precond=lambda r: jnp.einsum("vij,vj->vi", Pj, r)))

    At, Pt = T(A), T(Pinv)
    cg: list = []
    got = pcg_solve(lambda x: (At @ x.reshape(-1)).reshape(V, 7), T(b), cap,
                    precond=lambda r: torch.einsum("vij,vj->vi", Pt, r), cg_iters=cg).numpy()
    n = cg[0]
    want = jax_solve(cap)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    if cap == 5:
        assert n == 5
    else:
        assert 5 < n < cap
        np.testing.assert_array_equal(jax_solve(n), want)
        assert not np.allclose(jax_solve(n - 1), want, rtol=1e-9, atol=0)


# -- tiered BA against the JAX tiered BA ----------------------------------------


def _ring_problem(seed, V, M, a, scale, x_noise, uv_noise, dtype=np.float64):
    """The power-law track histograms of tests/test_global_ba.py:166-442
    (p50 ~2, a few points seen by most cameras) on the well-posed camera
    ring of :367-442. The random poses of :166-337 put points behind the
    cameras: there the JAX solve diverges (cost 9e5 -> NaN at V = 20,
    6e6 -> 1.2e7 at V = 40) and its parity checks compare NaN with NaN."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(2 + (rng.pareto(a, M) * scale).astype(int), V)
    th = np.linspace(0, 2 * np.pi, V, endpoint=False)
    C = np.stack([5 * np.cos(th), 5 * np.sin(th), 0.2 * np.sin(3 * th)], 1)
    Rs = []
    for c in C:
        z = -c / np.linalg.norm(c)  # look at the origin
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        Rs.append(np.stack([x, np.cross(z, x), z], axis=1))
    q = np.asarray(rotation_to_quat(jnp.asarray(np.stack(Rs))))
    X = rng.normal(size=(M, 3)) * 1.2
    cam = np.concatenate([rng.choice(V, size=c, replace=False) for c in counts]).astype(np.int32)
    pt = np.repeat(np.arange(M), counts).astype(np.int32)
    O = cam.shape[0]
    uv, _, _ = batched_residual_jacobians(jnp.asarray(C)[cam], jnp.asarray(q)[cam],
                                          jnp.asarray(X)[pt], jnp.zeros((O, 2)))
    uv = np.asarray(uv) * -1.0 + rng.normal(size=(O, 2)) * uv_noise
    Xn = X + rng.normal(size=X.shape) * x_noise
    order = np.argsort(-counts, kind="stable")
    arrays = dict(C=C, q=q, X=Xn[order], cam=cam, pt=pt, uv=uv)
    arrays = {k: (v.astype(dtype) if v.dtype.kind == "f" else v) for k, v in arrays.items()}
    return arrays, counts, order


def _run_tiered_both(arrays, counts, order, cfg, round_to):
    """Pack once per package and run both tiered BAs -> (jax costs, port
    costs, port PCG iterations)."""
    V, M = arrays["C"].shape[0], arrays["X"].shape[0]
    tiers = Jg.choose_tiers(counts[order], round_to=round_to)
    cfg = dataclasses.replace(cfg, obs_layout="tiered", tiers=tiers)
    O = arrays["cam"].shape[0]
    j_obs = Jg.pack_tiered(Jba.BAObservations(jnp.asarray(arrays["cam"]), jnp.asarray(arrays["pt"]),
                                              jnp.asarray(arrays["uv"]), jnp.ones(O, bool)),
                           tiers, order)
    j_st = Jba.BAState(jnp.asarray(arrays["C"]), jnp.asarray(arrays["q"]), jnp.asarray(arrays["X"]),
                       jnp.ones(V, bool), jnp.ones(M, bool))
    _, jc = Jba.run_bundle_adjustment(j_st, j_obs, cfg)
    t_obs = Tg.pack_tiered(Tba.BAObservations(T(arrays["cam"]), T(arrays["pt"]), T(arrays["uv"]),
                                              torch.ones(O, dtype=torch.bool)), tiers, order)
    t_st = Tba.BAState(T(arrays["C"]), T(arrays["q"]), T(arrays["X"]),
                       torch.ones(V, dtype=torch.bool), torch.ones(M, dtype=torch.bool))
    cg: list = []
    _, tc = Tba.run_bundle_adjustment(t_st, t_obs, port_config(cfg), cg_iters=cg)
    return np.asarray(jc), tc.numpy(), cg


def test_tiered_dense_ba_matches_jax():
    """Dense Schur solve at V = 20 with the track histogram of
    tests/test_global_ba.py:166-262 (f64, always-accept): costs to rtol
    1e-4."""
    arrays, counts, order = _ring_problem(3, 20, 256, 1.0, 3, 0.05, 2e-3)
    cfg = BAConfig(iterations=6, damping=1.0, adaptive=False)
    jc, tc, cg = _run_tiered_both(arrays, counts, order, cfg, round_to=32)
    assert cg == []
    assert np.isfinite(jc).all() and jc[-1] < 0.2 * jc[0]
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-10)


def test_tiered_pcg_cam_rows_ba_matches_jax():
    """PCG with the camera-major view at V = 40 with the histogram and
    settings of tests/test_global_ba.py:264-337 (f64, always-accept): costs
    to rtol 1e-3."""
    arrays, counts, order = _ring_problem(7, 40, 128, 1.2, 4, 0.005, 2e-4)
    cam_max = int(np.bincount(arrays["cam"], minlength=40).max())
    cfg = BAConfig(iterations=3, damping=10.0, adaptive=False, pcg_fallback_cameras=16,
                   pcg_iterations=96, cam_rows=((cam_max + 7) // 8) * 8)
    jc, tc, cg = _run_tiered_both(arrays, counts, order, cfg, round_to=16)
    assert len(cg) == 3 and all(0 < n <= 96 for n in cg)
    assert np.isfinite(jc).all() and jc[-1] < jc[0]
    np.testing.assert_allclose(tc, jc, rtol=1e-3, atol=1e-9)


def test_tiered_pcg_ring_matches_jax_pallas_matvec():
    """The V = 24 camera ring (tests/test_global_ba.py:367-442, f32): the
    JAX solve with matvec_impl='pallas' (interpreted kernels B5/B6) against
    the port, whose PCG always runs B5/B6 (here their plain versions) over
    a camera-major view it builds itself: costs to rtol 1e-3."""
    arrays, counts, order = _ring_problem(11, 24, 96, 1.2, 4, 0.005, 2e-4, dtype=np.float32)
    cfg = BAConfig(iterations=3, damping=1.0, adaptive=False, pcg_fallback_cameras=8,
                   pcg_iterations=64, matvec_impl="pallas")
    jc, tc, cg = _run_tiered_both(arrays, counts, order, cfg, round_to=16)
    assert len(cg) == 3
    np.testing.assert_allclose(tc, jc, rtol=1e-3)


@pytest.mark.parametrize("layout", ["csr", "ell_tail", "shards"])
def test_sharded_only_layouts_raise(layout):
    """The layouts the sharded solve uses and the sharded global solve, now
    ported (tests/test_torch_sharded.py holds them against the JAX
    package): the CSR stream and the hybrid-ELL tail run in one process and
    give the single-device ELL solve's costs to rtol 1e-9 (f64); the
    sharded global solve without a process group raises a ValueError that
    names torchrun."""
    rng = np.random.default_rng(0)
    V, M, per = 3, 4, 3
    cam = np.tile(np.arange(V, dtype=np.int32), M)
    pt = np.repeat(np.arange(M, dtype=np.int32), per)
    X = rng.normal(size=(M, 3)) + [0, 0, 8]
    C = rng.normal(size=(V, 3)) * 0.3
    uv = (X[pt, :2] - C[cam, :2]) / (X[pt, 2:] - C[cam, 2:]) + rng.normal(size=(M * per, 2)) * 1e-3
    q = np.tile([1.0, 0, 0, 0], (V, 1))
    st = Tba.BAState(T(C + 0.01), T(q), T(X + 0.02), torch.ones(V, dtype=torch.bool),
                     torch.ones(M, dtype=torch.bool))
    obs = Tba.BAObservations(T(cam), T(pt), T(uv), torch.ones(M * per, dtype=torch.bool))
    if layout == "shards":
        prob = Tg.GlobalProblem(st, obs, np.arange(M), V, M, M * per, per)
        with pytest.raises(ValueError, match="torchrun"):
            Tg.solve_global(prob, port_config(BAConfig()), num_shards=4)
        return
    base = BAConfig(iterations=4, damping=1.0, fix_first_camera_gauge=True)
    extra = dict(obs_layout="csr") if layout == "csr" else dict(ell_rows=1, ell_tail=8)
    cfg = dataclasses.replace(base, **extra)
    _, want = Tba.run_bundle_adjustment(st, obs, port_config(base))
    _, got = Tba.run_bundle_adjustment(st, obs, port_config(cfg))
    assert float(want[-1]) < float(want[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9)


@pytest.mark.parametrize("round_to", [16, 256])
def test_choose_tiers_and_pack_tiered_equal_jax(round_to):
    """Tier partition and the packed stream: exact equality, including a
    degenerate histogram (a few very long tracks) that triggers the padding
    budget."""
    rng = np.random.default_rng(round_to)
    M = 3000
    counts = np.minimum(1 + (rng.pareto(1.0, M) * 3).astype(int), 400)
    counts[:3] = 5000
    counts[-40:] = 0
    order = np.argsort(-counts, kind="stable")
    tiers = Tg.choose_tiers(counts[order], round_to=round_to)
    assert tiers == Jg.choose_tiers(counts[order], round_to=round_to)
    sub = counts.clip(max=40)
    cam = np.concatenate([rng.choice(64, size=c, replace=False) for c in sub]).astype(np.int32)
    pt = np.repeat(np.arange(M), sub).astype(np.int32)
    uv = rng.normal(size=(cam.size, 2)).astype(np.float32)
    valid = rng.random(cam.size) < 0.95
    order = np.argsort(-np.bincount(pt[valid], minlength=M), kind="stable")
    tiers = Tg.choose_tiers(np.bincount(pt[valid], minlength=M)[order], round_to=round_to)
    want = Jg.pack_tiered(Jba.BAObservations(*(jnp.asarray(a) for a in (cam, pt, uv, valid))),
                          tiers, order)
    got = Tg.pack_tiered(Tba.BAObservations(*(T(a) for a in (cam, pt, uv, valid))), tiers, order)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- eviction -----------------------------------------------------------------------


def _evict_both(state_np: dict):
    j_state, j_rec = Jtr.evict_oldest_view(Jtr.SfMState(**{k: jnp.asarray(v)
                                                           for k, v in state_np.items()}))
    t_state, t_rec = Ttr.evict_oldest_view(state_from_numpy(state_np, "cpu"))
    got = state_to_numpy(t_state)
    for k, v in _np(j_state).items():
        np.testing.assert_array_equal(got[k], v.astype(got[k].dtype), err_msg=k)
    for f in Ttr.EvictionRecord._fields:
        g = getattr(t_rec, f).numpy()
        np.testing.assert_array_equal(g, np.asarray(getattr(j_rec, f)).astype(g.dtype), err_msg=f)
    return t_rec


def test_evict_oldest_view_small_state_matches_jax():
    """The small state of tests/test_global_ba.py:55-90: the evicted state
    and the record are equal exactly."""
    cap = CapacityConfig(max_views=3, max_keypoints=8, max_points=16, max_observations=32)
    st = Jtr.init_state(cap, jnp.asarray([[100.0, 0, 50.0], [0, 100.0, 40.0], [0, 0, 1.0]],
                                         jnp.float32))
    st = Jtr.set_camera(st, 0, jnp.asarray([1.0, 2, 3], jnp.float32),
                        jnp.asarray([1.0, 0, 0, 0], jnp.float32))
    X = jnp.asarray([[0.0, 0, 10], [1.0, 0, 10], [2.0, 0, 10]], jnp.float32)
    st, ids, _ = Jtr.allocate_points(st, X, jnp.ones(3, bool))
    st = Jtr.append_observations(
        st, cam=jnp.asarray([0, 0, 1, 1, 1]),
        point=jnp.asarray([ids[0], ids[2], ids[0], ids[1], ids[2]]),
        uv=jnp.asarray([[5.0, 6], [7.0, 8], [1.0, 1], [2.0, 2], [3.0, 3]], jnp.float32),
        mask=jnp.ones(5, bool))
    rec = _evict_both(_np(st))
    assert int(rec.valid.sum()) == 2


# -- slide runs of both engines -------------------------------------------------------


@pytest.fixture(scope="module")
def slide_runs(pipeline_config):  # noqa: F811
    """A 12-frame, window-6 slide run with precomputed features
    (tests/test_global_ba.py:93-103, noise 0.4 px) through both engines."""
    K, frames, C_gt, _, _ = synthetic_sequence(n_views=12, n_points=300, seed=2, noise=0.4)
    cfg = dataclasses.replace(pipeline_config, window_size=6, window_mode="slide")
    jeng = JaxSfM(cfg, K, frontend="precomputed")
    teng = IncrementalSfM(port_config(cfg), K, frontend="precomputed", device="cpu")
    for f in frames:
        jeng.process_features(*f)
        teng.process_features(*f)
    return dict(jax=jeng, port=teng, C_gt=C_gt, cfg=cfg, K=K)


def test_slide_run_matches_jax(slide_runs):
    """12 poses from each engine (6 archived + 6 live); the port's centres
    lie within 5% of the span of JAX's after similarity alignment; 6
    records archived."""
    jl, _ = slide_runs["jax"].poses()
    tl, tr = slide_runs["port"].poses()
    assert tl.shape == (12, 3) and tr.shape == (12, 3, 3)
    assert len(slide_runs["port"]._archive) == 6
    span = float(np.linalg.norm(jl.max(0) - jl.min(0)))
    assert umeyama_ate(tl, jl) / span < 0.05
    assert slide_runs["port"].reprojection_error() < 2.0


def test_evict_oldest_view_engine_state_matches_jax(slide_runs):
    """A JAX engine's full state after a slide run, carried across with
    state_from_numpy: the evicted state and the record are equal exactly."""
    rec = _evict_both(_np(slide_runs["jax"].state))
    assert int(rec.valid.sum()) > 50


def test_finalize_global_improves_port_trajectory(slide_runs):
    """The port's finalize_global(15) (dense tiered solve at V = 12) lowers
    its cost by >= 5%, moves the archive, and its ATE after is <= 1.05 x
    before; rotations stay orthonormal; finalize() then runs."""
    eng = copy.deepcopy(slide_runs["port"])
    C_gt = slide_runs["C_gt"]
    before, _ = eng.poses()
    info = eng.finalize_global(iterations=15)
    assert info["n_cams"] == 12 and info["cg_iterations"] == []
    assert info["costs"][-1] <= 0.95 * info["costs"][0]
    after, rots = eng.poses()
    assert not np.allclose(after, before)
    assert umeyama_ate(after, C_gt) <= 1.05 * umeyama_ate(before, C_gt) + 1e-6
    np.testing.assert_allclose(np.einsum("fij,fkj->fik", rots, rots),
                               np.broadcast_to(np.eye(3), rots.shape), atol=1e-5)
    costs = eng.finalize(iterations=4)
    assert costs.shape == (4,) and np.isfinite(costs).all()


def test_build_global_problem_matches_jax_on_carried_state(slide_runs):
    """The JAX engine's state and archive, carried into the port: the global
    problem is equal array for array."""
    jeng = slide_runs["jax"]
    n_live = min(jeng._frame, jeng._window)
    want = Jg.build_global_problem(jeng.state, jeng._archive, n_live)
    archive = archive_from_numpy(jeng._archive)
    got = Tg.build_global_problem(state_from_numpy(_np(jeng.state), "cpu"), archive, n_live)
    _assert_problem_equal(got, want)
    assert got.n_cams == 12


def _assert_problem_equal(got, want):
    for g, w in zip(list(got.state) + list(got.obs), list(want.state) + list(want.obs)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.gids, want.gids)
    assert got[3:] == want[3:]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_round_trip_between_packages(slide_runs, tmp_path, direction):
    """A checkpoint written by one package loads into the other: state,
    frame, archive (the __archive_* keys) and keyframes (__keyframe_*) equal
    exactly; the resumed port engine reports the same poses."""
    path = str(tmp_path / "ck.npz")
    jeng, teng = slide_runs["jax"], slide_runs["port"]
    if direction == "jax_to_port":
        jeng.save_checkpoint(path)
        state, frame, archive, kf = Tck.load_state(path, "cpu")
        want_state, want_archive = _np(jeng.state), jeng._archive
        want_kf = (jeng.keyframe_indices, jeng._input_index)
        got_state, got_archive = state_to_numpy(state), archive_to_numpy(archive)
        resumed = IncrementalSfM(port_config(slide_runs["cfg"]), slide_runs["K"], frontend="precomputed",
                                 device="cpu")
        assert resumed.load_checkpoint(path) == 12
        np.testing.assert_array_equal(resumed.poses()[0], jeng.poses()[0])
    else:
        teng.save_checkpoint(path)
        state, frame, archive, kf = Jck.load_state(path)
        want_state, want_archive = state_to_numpy(teng.state), archive_to_numpy(teng._archive)
        want_kf = (teng.keyframe_indices, teng._frame)
        got_state, got_archive = _np(state), archive
    assert frame == 12 and kf == (list(want_kf[0]), want_kf[1])
    for k, v in want_state.items():
        np.testing.assert_array_equal(np.asarray(got_state[k]), v, err_msg=k)
    assert len(got_archive) == len(want_archive) == 6
    for g, w in zip(got_archive, want_archive):
        for f in Ttr.EvictionRecord._fields:
            gv = g[f] if isinstance(g, dict) else getattr(g, f)
            wv = w[f] if isinstance(w, dict) else getattr(w, f)
            np.testing.assert_array_equal(np.asarray(gv), np.asarray(wv), err_msg=f)


# -- the 500-camera artifact ---------------------------------------------------------


def _artifact_config(pipeline_config):  # noqa: F811
    """examples/run_long_sequence.py's engine config at the artifact's
    capacities (window 8, 1024 keypoints)."""
    return dataclasses.replace(
        pipeline_config,
        frontend=FrontendConfig(max_keypoints=1024, upsample_first_octave=False),
        ba=BAConfig(iterations=3, damping=5.0, huber_delta=0.01),
        capacity=CapacityConfig(max_views=8, max_keypoints=1024, max_points=8192,
                                max_observations=32768),
        window_size=8, window_mode="slide",
    )


def test_artifact_loads_and_global_problem_matches_jax():
    """artifacts/longrun500_pre_globalba.ckpt.npz through the port's
    load_state: the global problem equals JAX's array for array (500
    cameras, 6,052 points, 159,035 observations)."""
    state, frame, archive, _ = Tck.load_state(ARTIFACT, "cpu")
    jstate, jframe, jarchive, _ = Jck.load_state(ARTIFACT)
    assert frame == jframe == 500 and len(archive) == 492
    got = Tg.build_global_problem(state, archive, min(frame, 8))
    want = Jg.build_global_problem(jstate, jarchive, min(jframe, 8))
    _assert_problem_equal(got, want)
    assert (got.n_cams, got.n_points, got.n_obs, got.max_track_len) == (500, 6052, 159035, 500)


def _finalize_artifact(cfg, iterations):
    jeng = JaxSfM(cfg, np.eye(3), frontend="precomputed")
    jeng.load_checkpoint(ARTIFACT)
    want = jeng.finalize_global(iterations=iterations)
    teng = IncrementalSfM(port_config(cfg), np.eye(3), frontend="precomputed", device="cpu")
    teng.load_checkpoint(ARTIFACT)
    got = teng.finalize_global(iterations=iterations)
    return got, want, teng


def test_finalize_global_artifact_two_iterations_match_jax(pipeline_config):  # noqa: F811
    """finalize_global(2) on the 500-camera artifact (f32, Huber 0.01, PCG
    with B5/B6's plain versions): both LM costs to rtol 1e-3 of JAX's."""
    got, want, teng = _finalize_artifact(_artifact_config(pipeline_config), 2)
    np.testing.assert_allclose(got["costs"], np.asarray(want["costs"]), rtol=1e-3)
    assert got["slots"] == 233984 and len(got["cg_iterations"]) == 2
    assert got["tiers"] == ((256, 500), (256, 250), (256, 106), (256, 11), (1536, 3), (3584, 2))
    assert teng.poses()[0].shape == (500, 3)


@pytest.mark.slow
def test_finalize_global_artifact_twenty_iterations_match_jax(pipeline_config):  # noqa: F811
    """finalize_global(20) on the artifact: the final cost within 1% of
    JAX's, and at most 0.3 x the first."""
    got, want, _ = _finalize_artifact(_artifact_config(pipeline_config), 20)
    np.testing.assert_allclose(got["costs"][-1], np.asarray(want["costs"])[-1], rtol=1e-2)
    assert got["costs"][-1] <= 0.3 * got["costs"][0]
