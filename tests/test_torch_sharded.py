"""The port's sharded bundle adjustment (``parallel/``), the CSR and
hybrid-ELL layouts it uses, the sharded global solve and the per-frame
sharded engine, against the JAX package's ``parallel/`` on the conftest's
virtual CPU mesh at ``make_mesh(2)`` (the twins of tests/test_ba_sharded.py
and tests/test_distributed.py).

The S = 2 cases run as two gloo ranks on the CPU, started ONCE for the
module (``torch.multiprocessing``, one intra-op thread each) while the
parent computes the JAX references; each rank saves what it computed and
the tests read both ranks' results. The S = 1 cases run in this process
(no group: the sum over ranks is the identity). Inputs are made from numpy
seeds (``tests/test_ba.make_scene``) and go through both packages in f64;
each test states its tolerance."""

import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from structure_from_motion_tpu import parallel as Jpar
from structure_from_motion_tpu.config import (
    BAConfig,
    CapacityConfig,
    FrontendConfig,
    LMConfig,
    MatcherConfig,
    PipelineConfig,
    RansacConfig,
)
from structure_from_motion_tpu.models import global_ba as Jg
from structure_from_motion_tpu.models import incremental as Ji
from structure_from_motion_tpu.models import tracks as Jtr
from structure_from_motion_tpu.ops import ba as Jba
from structure_from_motion_tpu_torch import parallel as Tpar
from structure_from_motion_tpu_torch.convert import state_from_numpy, state_to_numpy
from structure_from_motion_tpu_torch.models import global_ba as Tg
from structure_from_motion_tpu_torch.models import incremental as Ti
from structure_from_motion_tpu_torch.ops import ba as Tba
from tests.test_ba import make_scene, perturb
from tests.test_incremental import synthetic_sequence, umeyama_ate
from tests.test_torch_config import port_config

S = 2
DENSE = BAConfig(iterations=8, damping=5.0, fix_first_camera_gauge=True)
PCG = BAConfig(iterations=10, damping=5.0, fix_first_camera_gauge=True, pcg_fallback_cameras=1,
               pcg_iterations=128)
PCG_DENSE = BAConfig(iterations=10, damping=5.0, fix_first_camera_gauge=True)
GLOBAL = BAConfig(damping=5.0, fix_first_camera_gauge=True)
PIPELINE = PipelineConfig(
    frontend=FrontendConfig(max_keypoints=256, upsample_first_octave=False),
    matcher=MatcherConfig(ratio=0.9),
    fundamental_ransac=RansacConfig(inlier_threshold=2.0, iteration=128),
    pnp_ransac=RansacConfig(inlier_threshold=8.0, sample_num=6, iteration=256),
    pnp_lm=LMConfig(damping=5.0, iterations=50),
    triangulation_lm=LMConfig(damping=5.0, iterations=25),
    ba=BAConfig(iterations=3, damping=5.0),
    capacity=CapacityConfig(max_views=8, max_keypoints=256, max_points=1024,
                            max_observations=4096),
)
SHARDED = dataclasses.replace(PIPELINE, ba_num_shards=S)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _state(arrays) -> Tba.BAState:
    return Tba.BAState(*(torch.as_tensor(np.array(a)) for a in arrays))


def _obs(arrays) -> Tba.BAObservations:
    return Tba.BAObservations(*(torch.as_tensor(np.array(a)) for a in arrays))


def _inputs() -> dict:
    """Every case's inputs as numpy, the same in both packages."""
    clean, obs, _ = make_scene(cap_m=128, cap_o=1024)
    K, frames, C_gt, _, _ = synthetic_sequence(n_views=4, n_points=200, kp_cap=256)
    # the state a frame's BA stage starts from: a single port engine's
    # after 3 frames (the per-frame sharded stage's input)
    eng = Ti.IncrementalSfM(port_config(PIPELINE), K, frontend="precomputed", device="cpu")
    for f in frames[:3]:
        eng.process_features(*f)
    stage = state_to_numpy(eng.state)
    # noise-free frames leave nothing to refine: perturb the map and the
    # cameras after the first, so the costs are far above f32 round-off
    rng = np.random.default_rng(2)
    stage["points"] = stage["points"] + (rng.normal(size=stage["points"].shape) * 0.02
                                         * stage["pt_valid"][:, None]).astype(np.float32)
    stage["cam_C"][1:3] += (rng.normal(size=(2, 3)) * 0.01).astype(np.float32)
    return dict(
        noisy={k: _np(v) for k, v in perturb(clean, seed=11)._asdict().items()},
        noisy_pcg={k: _np(v) for k, v in perturb(clean, seed=5)._asdict().items()},
        noisy_global={k: _np(v) for k, v in perturb(clean)._asdict().items()},
        obs={k: _np(v) for k, v in obs._asdict().items()},
        K=K, frames=frames, C_gt=C_gt, stage_state=stage,
    )


def _global_problem(inp, pkg):
    st, ob = inp["noisy_global"], inp["obs"]
    counts = np.bincount(ob["point"][ob["valid"]], minlength=128)
    if pkg == "jax":
        state = Jba.BAState(**{k: jnp.asarray(v) for k, v in st.items()})
        obs = Jba.BAObservations(**{k: jnp.asarray(v) for k, v in ob.items()})
        make = Jg.GlobalProblem
    else:
        state, obs, make = _state(st.values()), _obs(ob.values()), Tg.GlobalProblem
    return make(state=state, obs=obs, gids=np.arange(128), n_cams=8, n_points=128,
                n_obs=int(ob["valid"].sum()), max_track_len=int(counts.max()))


def _rank_cases(inp) -> dict:
    """Everything the ranks compute, each rank its own shard."""
    mesh = Tpar.make_mesh(S)
    obs = _obs(inp["obs"].values())
    res = {}

    def run(name, st, part, cfg, m=mesh, interleaved=False):
        out, costs = Tpar.sharded_bundle_adjustment(st, part, port_config(cfg), m)
        X = Tpar.gather_point_shards(out.X, m)
        res[name] = dict(C=_np(out.C), q=_np(out.q), costs=_np(costs),
                         X=_np(Tpar.deinterleave_points(X, S) if interleaved else X))

    noisy = _state(inp["noisy"].values())
    part = Tpar.partition_observations(obs, 128, S, 512, interleave=True)
    res["interleaved_valid"] = int(part.valid.sum())
    run("interleaved", noisy._replace(X=Tpar.interleave_points(noisy.X, S),
                                      pt_valid=Tpar.interleave_points(noisy.pt_valid, S)),
        part, DENSE, interleaved=True)
    block = Tpar.partition_observations(obs, 128, S, 512)
    run("block", noisy, block, DENSE)
    mesh2d = Tpar.make_mesh_2d(2, 1)
    res["mesh2d_shape"] = mesh2d.shape
    run("mesh2d", noisy, block, DENSE, m=mesh2d)
    run("pcg", _state(inp["noisy_pcg"].values()), block, PCG)

    stats: dict = {}
    out, costs = Tg.solve_global(_global_problem(inp, "port"), port_config(GLOBAL), iterations=6,
                                 num_shards=S, stats=stats)
    res["global"] = dict(C=_np(out.C), q=_np(out.q), X=_np(out.X), pt_valid=_np(out.pt_valid),
                         costs=costs, tail=stats["tail"])

    st, costs, dropped, _, _ = Ti._ba_stage(state_from_numpy(inp["stage_state"], "cpu"),
                                            port_config(SHARDED))
    res["stage"] = dict(cam_C=_np(st.cam_C), cam_q=_np(st.cam_q), points=_np(st.points),
                        costs=_np(costs), dropped=int(dropped))

    eng = Ti.IncrementalSfM(port_config(SHARDED), inp["K"], frontend="precomputed", device="cpu")
    dropped = [int(eng.process_features(*f).get("ba_dropped_obs", 0)) for f in inp["frames"]]
    res["pipeline"] = dict(cam_C=_np(eng.state.cam_C), locs=eng.poses()[0], dropped=dropped,
                           num_points=int(eng.state.num_points),
                           reproj=eng.reprojection_error())
    return res


def _rank_main(rank: int, port: int, inp: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=S,
                            rank=rank)
    try:
        res = _rank_cases(inp)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_state(arrays) -> Jba.BAState:
    return Jba.BAState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _as_np(out, costs, interleaved=False) -> dict:
    X = Jpar.deinterleave_points(out.X, S) if interleaved else out.X
    return dict(C=np.asarray(out.C), q=np.asarray(out.q), X=np.asarray(X),
                costs=np.asarray(costs))


def _jax_references(inp) -> dict:
    """The JAX package on the same inputs: its sharded dense solve at
    make_mesh(2) (one compiled program for both partitions), its sharded BA
    stage, and the single-device dense, PCG and tiered global solves (each
    sharded compile costs ~13 s on the CPU: the sharded PCG and global
    solves are held against the JAX sharded ones in the slow tests)."""
    mesh = Jpar.make_mesh(S)
    st = _jax_state(inp["noisy"])
    obs = Jba.BAObservations(**{k: jnp.asarray(v) for k, v in inp["obs"].items()})
    dense = jax.jit(lambda s, o: Jpar.sharded_bundle_adjustment(s, o, DENSE, mesh))
    part = Jpar.partition_observations(obs, 128, S, 512, interleave=True)
    ref = dict(
        interleaved=_as_np(*dense(st._replace(X=Jpar.interleave_points(st.X, S),
                                              pt_valid=Jpar.interleave_points(st.pt_valid, S)),
                                  part), interleaved=True),
        block=_as_np(*dense(st, Jpar.partition_observations(obs, 128, S, 512))),
        single=_as_np(*Jba.run_bundle_adjustment(st, obs, DENSE)),
        # the JAX test's anchor of the sharded PCG: the dense solve
        pcg_single=_as_np(*Jba.run_bundle_adjustment(_jax_state(inp["noisy_pcg"]), obs,
                                                     PCG_DENSE)),
    )
    out, costs = Jg.solve_global(_global_problem(inp, "jax"), GLOBAL, iterations=6, num_shards=1)
    ref["global_single"] = dict(_as_np(out, costs), pt_valid=np.asarray(out.pt_valid))
    j_state = Jtr.SfMState(**{k: jnp.asarray(v) for k, v in inp["stage_state"].items()})
    jo, jcost, jdrop, _, _ = Ji._ba_stage(j_state, config=SHARDED)
    ref["stage"] = dict(cam_C=np.asarray(jo.cam_C), cam_q=np.asarray(jo.cam_q),
                        points=np.asarray(jo.points), costs=np.asarray(jcost), dropped=int(jdrop))
    return ref


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(rank 0's results, rank 1's, the JAX references, the inputs): the two
    gloo ranks run while this process computes the references."""
    inp = _inputs()
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    ctx = tmp.start_processes(_rank_main, args=(_free_port(), inp, out_dir), nprocs=S,
                              join=False, start_method="spawn")
    try:
        ref = _jax_references(inp)
    finally:
        while not ctx.join(timeout=600):
            pass
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(S)]
    return ranks[0], ranks[1], ref, inp


def _replicated_equal(r0, r1, case, keys=("C", "q")):
    for k in keys:
        assert np.array_equal(r0[case][k], r1[case][k]), f"{case}.{k} differs between ranks"


def test_partition_observations_routing():
    """Block and interleaved routing equal the JAX partition slot for slot
    (8 shards of 128 slots), and every valid observation survives."""
    _, obs, _ = make_scene(cap_m=128, cap_o=1024)
    tobs = _obs([_np(t) for t in obs])
    for interleave in (False, True):
        want = Jpar.partition_observations(obs, num_points=128, num_shards=8,
                                           per_shard_capacity=128, interleave=interleave)
        got = Tpar.partition_observations(tobs, 128, 8, 128, interleave=interleave)
        assert int(got.valid.sum()) == int(obs.valid.sum())
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_partition_overflow_drops_and_counts():
    """A bucket too small for its shard drops the excess into the dump slot,
    exactly as the JAX partition does; the returned validity counts it."""
    _, obs, _ = make_scene(cap_m=128, cap_o=1024)
    want = Jpar.partition_observations(obs, 128, 4, 40, interleave=True)
    got = Tpar.partition_observations(_obs([_np(t) for t in obs]), 128, 4, 40, interleave=True)
    assert int(obs.valid.sum()) - int(got.valid.sum()) == 240 - 160
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_interleave_points_roundtrip():
    x = torch.arange(24.0).reshape(12, 2)
    for s in (1, 2, 3, 4, 6):
        y = Tpar.interleave_points(x, s)
        np.testing.assert_array_equal(_np(y), np.asarray(Jpar.interleave_points(jnp.asarray(
            _np(x)), s)))
        assert torch.equal(Tpar.deinterleave_points(y, s), x)
    # shard 1 of 4 owns global ids 1, 5, 9 at local offsets 0, 1, 2
    assert torch.equal(Tpar.interleave_points(x, 4)[3:6], x[[1, 5, 9]])


def test_one_shard_in_process_equals_the_single_solve(sharded):
    """S = 1 without a group (the sum over ranks is the identity): the
    sharded layout in one process equals the port's and the JAX package's
    single-device solves: costs rtol 1e-9, C, q, X atol 1e-8 (f64)."""
    _, _, ref, inp = sharded
    mesh = Tpar.make_mesh(1)
    assert mesh.group is None and mesh.size == 1
    tst, obs = _state(inp["noisy"].values()), _obs(inp["obs"].values())
    got, tcosts = Tpar.sharded_bundle_adjustment(
        tst, Tpar.partition_observations(obs, 128, 1, 1024), port_config(DENSE), mesh)
    single, scosts = Tba.run_bundle_adjustment(tst, obs, port_config(DENSE))
    np.testing.assert_allclose(_np(tcosts), ref["single"]["costs"], rtol=1e-9)
    np.testing.assert_allclose(_np(tcosts), _np(scosts), rtol=1e-9)
    for k in ("C", "q", "X"):
        np.testing.assert_allclose(_np(getattr(got, k)), ref["single"][k], atol=1e-8)
        np.testing.assert_allclose(_np(getattr(got, k)), _np(getattr(single, k)), atol=1e-8)


@pytest.mark.parametrize("layout", ["csr", "ell_tail"])
def test_csr_and_hybrid_ell_layouts_equal_jax(layout):
    """The CSR stream and the hybrid ELL (2 rows a point, the other 2
    observations of each point in a 160-slot tail), dense solve and PCG:
    costs rtol 1e-9, C, q, X atol 1e-8 against the JAX package (f64)."""
    clean, obs, _ = make_scene(cap_m=128, cap_o=1024)
    noisy = perturb(clean, seed=3)
    extra = dict(obs_layout="csr") if layout == "csr" else dict(ell_rows=2, ell_tail=160)
    for base in (DENSE, dataclasses.replace(PCG, iterations=4, pcg_iterations=32)):
        cfg = dataclasses.replace(base, **extra)
        want, jc = Jba.run_bundle_adjustment(noisy, obs, cfg)
        got, tc = Tba.run_bundle_adjustment(_state([_np(t) for t in noisy]),
                                            _obs([_np(t) for t in obs]), port_config(cfg))
        np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=1e-9)
        for k in ("C", "q", "X"):
            np.testing.assert_allclose(_np(getattr(got, k)), np.asarray(getattr(want, k)),
                                       atol=1e-8)


def test_hybrid_ell_packing_equals_jax():
    """The packed stream of the hybrid ELL, tail point ids (m - 1 in the
    empty tail slots) included, equals the JAX package's slot for slot; a
    tail too short drops the rest, as there."""
    _, obs, _ = make_scene(cap_m=128, cap_o=1024)
    tobs = _obs([_np(t) for t in obs])
    for tail in (160, 96):
        want = Jba._to_ell(obs, 128, 2, tail)
        got = Tba._to_ell(tobs, 128, 2, tail)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_sharded_matches_jax_at_two_ranks(sharded):
    """Interleaved and block partitions over two gloo ranks against the JAX
    sharded solve at make_mesh(2) (dense Schur, f64): costs rtol 1e-9, C, q,
    X atol 1e-8; both ranks hold the same camera bits; nothing dropped."""
    r0, r1, ref, inp = sharded
    assert r0["interleaved_valid"] == int(inp["obs"]["valid"].sum())
    for case in ("interleaved", "block"):
        _replicated_equal(r0, r1, case)
        np.testing.assert_array_equal(r0[case]["X"], r1[case]["X"])
        np.testing.assert_allclose(r0[case]["costs"], ref[case]["costs"], rtol=1e-9)
        for k in ("C", "q", "X"):
            np.testing.assert_allclose(r0[case][k], ref[case][k], atol=1e-8, err_msg=case + k)


def test_sharded_matches_the_single_device_solve(sharded):
    """The two-rank solve against the JAX single-device solve (the JAX
    test's bar, tests/test_ba_sharded.py:57): costs rtol 1e-6, C, q, X atol
    1e-8."""
    r0, _, ref, _ = sharded
    single = ref["single"]
    np.testing.assert_allclose(r0["interleaved"]["costs"], single["costs"], rtol=1e-6)
    for k in ("C", "q", "X"):
        np.testing.assert_allclose(r0["interleaved"][k], single[k], atol=1e-8)


def test_sharded_2d_mesh_hosts_by_chips(sharded):
    """A (2 hosts, 1 chip) mesh (``init_device_mesh``) gangs both axes into
    the one sum: the same bits as make_mesh(2) over the same ranks, and the
    JAX sharded solve's numbers (costs rtol 1e-9, C atol 1e-8); the JAX
    test's bar against the single-device solve (costs rtol 1e-6, C atol
    1e-8)."""
    r0, r1, ref, _ = sharded
    assert tuple(r0["mesh2d_shape"]) == (2, 1)
    _replicated_equal(r0, r1, "mesh2d")
    for k in ("C", "q", "costs"):
        np.testing.assert_array_equal(r0["mesh2d"][k], r0["block"][k])
    np.testing.assert_allclose(r0["mesh2d"]["costs"], ref["block"]["costs"], rtol=1e-9)
    np.testing.assert_allclose(r0["mesh2d"]["C"], ref["block"]["C"], atol=1e-8)
    np.testing.assert_allclose(r0["mesh2d"]["costs"], ref["single"]["costs"], rtol=1e-6)
    np.testing.assert_allclose(r0["mesh2d"]["C"], ref["single"]["C"], atol=1e-8)


def test_sharded_pcg_matches_the_single_device_solve(sharded):
    """Sharded matrix-free PCG over two ranks (every matvec's coupling
    summed over them) against the JAX single-device dense solve (the JAX
    test's bar, tests/test_ba_sharded.py:230: the first 4 cameras' C atol
    5e-3, the cost down 1000x); both ranks the same bits."""
    r0, r1, ref, _ = sharded
    _replicated_equal(r0, r1, "pcg")
    np.testing.assert_allclose(r0["pcg"]["C"][:4], ref["pcg_single"]["C"][:4], atol=5e-3)
    assert r0["pcg"]["costs"][-1] < 1e-3 * r0["pcg"]["costs"][0]


@pytest.mark.slow
def test_sharded_pcg_matches_jax(sharded):
    """The two-rank sharded PCG against the JAX sharded PCG at make_mesh(2):
    costs rtol 1e-6, C atol 1e-6 (f64; the CG stop test reads sums taken in
    another order)."""
    r0, _, _, inp = sharded
    obs = Jba.BAObservations(**{k: jnp.asarray(v) for k, v in inp["obs"].items()})
    want = _as_np(*Jpar.sharded_bundle_adjustment(
        _jax_state(inp["noisy_pcg"]), Jpar.partition_observations(obs, 128, S, 512), PCG,
        Jpar.make_mesh(S)))
    np.testing.assert_allclose(r0["pcg"]["costs"], want["costs"], rtol=1e-6)
    np.testing.assert_allclose(r0["pcg"]["C"], want["C"], atol=1e-6)


def test_two_rank_global_solve_matches_the_single_device_solve(sharded):
    """``solve_global(num_shards=2)`` over two ranks (hybrid ELL a shard,
    the twin of tests/test_distributed.py's global mode) against the JAX
    single-device tiered solve, that test's bar: costs rtol 1e-6, C and q
    atol 1e-7; X atol 1e-7 and pt_valid in the problem's point order; every
    rank returns the same whole map."""
    r0, r1, ref, _ = sharded
    _replicated_equal(r0, r1, "global", ("C", "q", "X"))
    got, want = r0["global"], ref["global_single"]
    assert got["tail"] > 0
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-6)
    for k in ("C", "q", "X"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got["pt_valid"], want["pt_valid"])
    assert got["costs"][-1] <= got["costs"][0]


@pytest.mark.slow
def test_two_rank_global_solve_matches_jax(sharded):
    """The same against the JAX sharded global solve at make_mesh(2), whose
    pt_valid comes back interleaved (de-interleaved here): costs rtol 1e-6,
    C, q, X atol 1e-7."""
    r0, _, _, inp = sharded
    out, costs = Jg.solve_global(_global_problem(inp, "jax"), GLOBAL, iterations=6, num_shards=S)
    want = dict(_as_np(out, costs), pt_valid=np.asarray(Jpar.deinterleave_points(out.pt_valid, S)))
    got = r0["global"]
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-6)
    for k in ("C", "q", "X"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got["pt_valid"], want["pt_valid"])


def test_sharded_ba_stage_matches_jax(sharded):
    """The per-frame BA stage with ba_num_shards = 2 (full capacity, O / 2
    slots a shard, pruning) on a port engine's state after 3 frames,
    its map and cameras perturbed, against the JAX stage at make_mesh(2) on
    the same state (f32 state):
    costs rtol 1e-4, cameras and points atol 1e-4, no observation dropped."""
    r0, r1, ref, _ = sharded
    _replicated_equal(r0, r1, "stage", ("cam_C", "cam_q", "points"))
    got, want = r0["stage"], ref["stage"]
    assert got["dropped"] == want["dropped"] == 0
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-4)
    for k in ("cam_C", "cam_q", "points"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_pipeline_with_sharded_ba_matches_single_device(sharded):
    """``IncrementalSfM(ba_num_shards=2)`` on two ranks over 4 frames
    against the single-device port engine with the same seed (the JAX
    test's bar, tests/test_ba_sharded.py:176): cam_C atol 1e-4, the same
    map size, reprojection within 1e-3 px, ATE < 0.05; no observation
    dropped; both ranks the same camera bits."""
    r0, r1, _, inp = sharded
    assert np.array_equal(r0["pipeline"]["cam_C"], r1["pipeline"]["cam_C"])
    eng = Ti.IncrementalSfM(port_config(PIPELINE), inp["K"], frontend="precomputed",
                            device="cpu")
    for f in inp["frames"]:
        eng.process_features(*f)
    got = r0["pipeline"]
    assert got["dropped"] == [0] * len(inp["frames"])
    np.testing.assert_allclose(got["cam_C"], _np(eng.state.cam_C), atol=1e-4)
    assert got["num_points"] == int(eng.state.num_points)
    assert abs(got["reproj"] - eng.reprojection_error()) < 1e-3
    assert umeyama_ate(got["locs"], inp["C_gt"][: len(got["locs"])]) < 0.05


def test_shards_without_a_group_raise_naming_torchrun():
    """Two shards with no process group: the mesh, the engine and the
    sharded global solve refuse with a ValueError naming torchrun."""
    with pytest.raises(ValueError, match="torchrun"):
        Tpar.make_mesh(2)
    with pytest.raises(ValueError, match="torchrun"):
        Ti.IncrementalSfM(port_config(SHARDED), np.eye(3), frontend="precomputed", device="cpu")
    assert Tpar.initialize_distributed() is False
    assert Tpar.process_topology() == (1, 1)
