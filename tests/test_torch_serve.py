"""The port's export and serving (``structure_from_motion_tpu_torch/serve.py``)
against the JAX package's ``serve.py`` and its tests.

Twins of ``tests/test_serve.py`` at its sizes (512 keypoints, capacities 8 /
512 / 4096 / 16384): the served engine against the live one bit for bit,
its ``finalize``, slide mode, the artifact's ``__meta`` against the JAX
one, and the build directory of ``enable_compilation_cache``. Also the
pieces the export rests on: ``set_tri_index`` with repeated keys against the
JAX functions (one write a key), ``utils/control``'s ``switch``, ``loop``
and ``fori`` eager against exported, and ``torch.library.opcheck`` of each
``sfm::`` operator on its CPU implementation.

An export of the frame program takes minutes on the CPU (every rung of
every switch is traced), so the twins that serve frames share ONE export
and are ``slow``; their cheap twin serves the eviction and reprojection
programs of the same engine.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.config import CapacityConfig, FrontendConfig, MatcherConfig
from structure_from_motion_tpu.config import PipelineConfig as JaxConfig
from structure_from_motion_tpu.models import IncrementalSfM as JaxSfM
from structure_from_motion_tpu.models import tracks as Jtr
from structure_from_motion_tpu.serve import export_engine as jax_export_engine
from structure_from_motion_tpu_torch import kernels, serve
from structure_from_motion_tpu_torch.models import tracks as Ttr
from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
from structure_from_motion_tpu_torch.utils import control
from tests.test_incremental import synthetic_sequence, umeyama_ate
from tests.test_torch_config import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cfg(**kw):
    """``tests/test_serve.py``'s ``_cfg``."""
    return JaxConfig(
        frontend=FrontendConfig(max_keypoints=512, upsample_first_octave=False),
        matcher=MatcherConfig(ratio=0.9),
        capacity=CapacityConfig(max_views=8, max_keypoints=512, max_points=4096,
                                max_observations=16384),
        **kw,
    )


# the shared artifact's config: the JAX test's, with the slide-mode test's
# window (window 4, "slide"); the exported programs do not read the window
# (the host's policy), so one export serves both twins
SLIDE = dict(window_size=4, window_mode="slide")


def _live(frames_cfg=None, **kw):
    return IncrementalSfM(port_config(frames_cfg or _jax_cfg(**SLIDE)), kw.pop("K"),
                          frontend="precomputed", seed=0, device="cpu", **kw)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """ONE export of a precomputed-frontend engine's default programs."""
    K, *_ = synthetic_sequence(n_views=3)
    path = str(tmp_path_factory.mktemp("serve") / "pipeline.sfm.npz")
    sizes = serve.export_engine(_live(K=K), path)
    return path, sizes


# -- the cheap twin: the eviction and reprojection programs ----------------

@pytest.fixture(scope="module")
def small_artifact(tmp_path_factory):
    K, frames, *_ = synthetic_sequence(n_views=4, n_points=300)
    live = _live(K=K)
    for f in frames:
        live.process_features(*f)
    path = str(tmp_path_factory.mktemp("serve_small") / "pipeline.sfm.npz")
    sizes = serve.export_engine(live, path, programs=["evict", "reproj"])
    return live, path, sizes


def test_served_programs_give_the_live_bits(small_artifact):
    """The loaded programs on a live engine's state after 4 frames: the same
    bits as the live functions (the cheap twin of the frame twins below)."""
    live, path, sizes = small_artifact
    assert set(sizes) == {"evict", "reproj"} and all(s > 1000 for s in sizes.values())
    with np.load(path) as data:
        progs = {n: torch.export.load(io.BytesIO(bytes(data[f"prog_{n}"]))).module()
                 for n in ("evict", "reproj")}
    st = live.state
    n = len(Ttr.SfMState._fields)
    out = progs["evict"](*st)
    want_st, want_rec = Ttr.evict_oldest_view(st)
    for got, want in zip(out, (*want_st, *want_rec)):
        assert torch.equal(got, want)
    assert torch.equal(progs["reproj"](*st), Ttr.reprojection_error(st))
    assert len(out) == n + len(Ttr.EvictionRecord._fields)


def test_artifact_meta_matches_the_jax_one(small_artifact, tmp_path):
    """Twin of ``tests/test_serve.py:89``: the same ``__meta`` keys as the
    JAX artifact, the config loads into the JAX ``PipelineConfig``, the
    platform is the device exported on, ``__K`` is the state's K stack."""
    live, path, _ = small_artifact
    K, *_ = synthetic_sequence(n_views=3)
    jpath = str(tmp_path / "jax.sfm.npz")
    jax_export_engine(JaxSfM(_jax_cfg(**SLIDE), K, frontend="precomputed", seed=0), jpath,
                      programs=["reproj"])
    with np.load(path) as data, np.load(jpath) as jdata:
        meta = json.loads(bytes(data["__meta"]).decode())
        jmeta = json.loads(bytes(jdata["__meta"]).decode())
        assert sorted(data.files) == sorted(
            ["__meta", "__K", "prog_evict", "prog_reproj"])
        assert data["__K"].shape == jdata["__K"].shape == (8, 3, 3)
    assert set(meta) == set(jmeta)
    # the JAX artifact's format is 1; the port's is 2 (its BA rungs clamp the map)
    assert meta["format_version"] == serve._FORMAT_VERSION == 2
    assert meta["frontend"] == "precomputed"
    assert meta["config"]["capacity"]["max_keypoints"] == 512
    assert meta["platforms"] == ["cpu"] and meta["programs"] == ["evict", "reproj"]
    assert meta["image_dtype"] == jmeta["image_dtype"] == "float32"
    assert JaxConfig.from_json(json.dumps(meta["config"])) == _jax_cfg(**SLIDE)
    assert meta["config"] == jmeta["config"]


class _PlainLoop(torch.nn.Module):
    def forward(self, x):
        i0 = torch.zeros((), dtype=torch.long)
        return control.loop(lambda i, x: i < 5, lambda i, x: (i + 1, x * 0.5), (i0, x))[1]


def test_served_engine_refuses_an_untagged_loop(small_artifact, tmp_path):
    """An artifact whose program holds a ``while_loop`` with no loop tag (a
    plain ``control.loop``, or an export from before the tags) is refused
    at load, naming the re-export: it is never served a read a step."""
    _, path, _ = small_artifact
    with control.export_tracing():
        ep = torch.export.export(_PlainLoop(), (torch.ones(3),), strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    with np.load(path) as data:
        files = {k: data[k] for k in data.files}
    files["prog_reproj"] = np.frombuffer(buf.getvalue(), np.uint8)
    bad = str(tmp_path / "untagged.sfm.npz")
    np.savez(bad, **files)
    with pytest.raises(ValueError, match="reproj: the while_loop node .* artifact again"):
        serve.load_engine(bad, device="cpu")


def test_served_engine_refuses_a_version_1_artifact(small_artifact, tmp_path):
    """An artifact of format 1, whose BA rungs do not clamp a map larger
    than the rung (every rung runs before a steady frame's capture), is
    refused at load, naming the re-export."""
    _, path, _ = small_artifact
    with np.load(path) as data:
        files = {k: data[k] for k in data.files}
    meta = json.loads(bytes(files["__meta"]).decode())
    meta["format_version"] = 1
    files["__meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    old = str(tmp_path / "v1.sfm.npz")
    np.savez(old, **files)
    with pytest.raises(ValueError, match="artifact format 1 != 2: export the engine again"):
        serve.load_engine(old, device="cpu")


def test_served_engine_refuses_what_it_cannot_serve(small_artifact):
    _, path, _ = small_artifact
    with pytest.raises(ValueError, match=r"exported for \['cpu'\]"):
        serve.load_engine(path, device="cuda")
    K, *_ = synthetic_sequence(n_views=3)
    native = IncrementalSfM(port_config(_jax_cfg()), K, frontend="native", device="cpu")
    with pytest.raises(ValueError, match="image_shape"):
        serve.export_engine(native, path + ".native")
    sharded = dataclasses.replace(port_config(_jax_cfg()), ba_num_shards=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.export_engine(type("E", (), {"config": sharded})(), path + ".sharded")


def test_compilation_cache_points_the_kernel_build(tmp_path, monkeypatch):
    """Twin of ``tests/test_serve.py:104``: the port compiles only its
    kernels, so the cache directory is where their library is built (at the
    first launch: nothing is built here)."""
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    cache = tmp_path / "kernel_cache"
    serve.enable_compilation_cache(str(cache))
    assert kernels.library_path().parent == cache.resolve()
    assert cache.is_dir() and not any(cache.iterdir())


# -- the frame twins (one shared export) ------------------------------------

@pytest.mark.slow
def test_export_load_reproduces_live_engine(artifact):
    """Twin of ``tests/test_serve.py:40``: live and served over 4 frames give
    the same bits in every state field and the same reprojection, each
    frame with the live engine's loop-mask reads; ATE < 0.03; the exported
    10-iteration finalize gives ``live.finalize(10)``'s costs and state bits
    and does not worsen the reprojection."""
    path, sizes = artifact
    assert set(sizes) == {"frame_step", "evict", "reproj", "finalize"}
    K, frames, C_gt, *_ = synthetic_sequence(n_views=4, n_points=300)
    live = _live(K=K)
    served = serve.load_engine(path, seed=0, device="cpu")
    for f in frames:
        reads = []
        for engine in (live, served):
            control.reset_stats()
            engine.process_features(*f)
            reads.append(control.stats.reads)
        assert reads[0] == reads[1], reads
    for name, a, b in zip(Ttr.SfMState._fields, live.state, served.state):
        assert torch.equal(a, b), name
    assert served.reprojection_error() == live.reprojection_error()
    assert umeyama_ate(served.poses()[0], C_gt) < 0.03
    before = live.reprojection_error()
    costs = served.finalize()
    assert costs.shape == (10,)
    np.testing.assert_array_equal(costs, live.finalize(10))
    for name, a, b in zip(Ttr.SfMState._fields, live.state, served.state):
        assert torch.equal(a, b), name
    assert served.reprojection_error() <= before + 1e-5
    with pytest.raises(ValueError, match="10 iterations"):
        served.finalize(iterations=3)


@pytest.mark.slow
def test_served_slide_mode_evicts(artifact):
    """Twin of ``tests/test_serve.py:73``: 6 frames in a window of 4 give 6
    poses (archive + window) within the JAX bound, the live engine's bits."""
    path, _ = artifact
    K, frames, C_gt, *_ = synthetic_sequence(n_views=6, n_points=250)
    live = _live(K=K)
    served = serve.load_engine(path, seed=0, device="cpu")
    for f in frames:
        live.process_features(*f)
        served.process_features(*f)
    locs, _ = served.poses()
    assert len(locs) == 6 and len(served._archive) == 2
    assert umeyama_ate(np.asarray(locs), C_gt) < 0.08
    np.testing.assert_array_equal(locs, live.poses()[0])


_NO_GEOMETRY = textwrap.dedent("""
    import sys
    import numpy as np
    from structure_from_motion_tpu_torch import serve
    from structure_from_motion_tpu_torch.models import incremental
    from structure_from_motion_tpu_torch.ops import pnp

    def refuse(*args, **kwargs):
        raise AssertionError("the served engine entered the Python geometry stack")

    pnp.estimate_pnp = incremental.estimate_pnp = refuse
    incremental._frame_step = incremental._single_step = refuse
    engine = serve.load_engine(sys.argv[1], seed=0, device="cpu")
    frames = np.load(sys.argv[2])
    for i in range(4):
        engine.process_features(frames["xy"][i], frames["desc"][i], frames["valid"][i])
    np.save(sys.argv[3], engine.poses()[0])
""")


@pytest.mark.slow
def test_served_run_never_reenters_the_geometry_stack(artifact, tmp_path):
    """In a fresh process with ``estimate_pnp`` and ``_frame_step`` made to
    raise, the served engine runs 4 frames, to the live engine's poses."""
    path, _ = artifact
    K, frames, *_ = synthetic_sequence(n_views=4, n_points=300)
    np.savez(tmp_path / "frames.npz", **{k: np.stack([f[i] for f in frames])
                                         for i, k in enumerate(("xy", "desc", "valid"))})
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_GEOMETRY, path, str(tmp_path / "frames.npz"),
         str(tmp_path / "locs.npy")], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    live = _live(K=K)
    for f in frames:
        live.process_features(*f)
    np.testing.assert_array_equal(np.load(tmp_path / "locs.npy"), live.poses()[0])


# -- one write per key -------------------------------------------------------

def _repeated_writes(seed, V=4, Kk=32, n=96):
    rng = np.random.default_rng(seed)
    st = Ttr.init_state(CapacityConfig(max_views=V, max_keypoints=Kk, max_points=64,
                                       max_observations=128), np.eye(3), desc_dim=8,
                        device="cpu")
    keys = rng.integers(0, 6, n).astype(np.int32)  # few keys: many repeats
    views = rng.integers(0, V, n).astype(np.int32)
    ids = rng.integers(0, 64, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    return st, views, keys, ids, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_set_tri_index_writes_each_key_once_like_jax(seed):
    st, views, keys, ids, mask = _repeated_writes(seed)
    jst = Jtr.init_state(CapacityConfig(max_views=4, max_keypoints=32, max_points=64,
                                        max_observations=128), np.eye(3), desc_dim=8)
    T = torch.from_numpy
    got = Ttr.set_tri_index(st, 2, T(keys), T(ids), T(mask)).tri_index.numpy()
    want = np.asarray(Jtr.set_tri_index(jst, 2, jnp.asarray(keys), jnp.asarray(ids),
                                        jnp.asarray(mask)).tri_index)
    np.testing.assert_array_equal(got, want)
    got = Ttr.set_tri_index_flat(st, T(views), T(keys), T(ids), T(mask)).tri_index.numpy()
    want = np.asarray(Jtr.set_tri_index_flat(jst, jnp.asarray(views), jnp.asarray(keys),
                                             jnp.asarray(ids), jnp.asarray(mask)).tri_index)
    np.testing.assert_array_equal(got, want)
    # at most one write per key: the winners are unique, the last masked one
    flat = views.astype(np.int64) * 32 + keys
    won = Ttr._last_writers(T(flat)[None], T(mask)[None], 4 * 32)[0].numpy()
    assert len(np.unique(flat[won])) == won.sum() == len(np.unique(flat[mask]))
    for key in np.unique(flat[mask]):
        assert won[np.flatnonzero(mask & (flat == key))[-1]]


# -- switch, loop and fori: eager against exported -------------------------

def _branch0(x, y, k):
    return x + y, (x * y).sum()


def _branch1(x, y, k):  # a one-lane lane_map inside a branch: no vmap in the graph
    out = control.lane_map(lambda a, b: a * b - b.sum(), x[None], y[None])
    return out[0], x.sum() - k


def _branch2(x, y, k):
    return x - y, y.amax()


def _steps(i, x, active, y):
    return i + 1, torch.where(active[:, None], 0.5 * x + y, x), active & (x.abs().sum(-1) > 1.0)


def _scaled(i, x, y):
    return (x * 0.9 + y * i,)


class _Flow(torch.nn.Module):
    def forward(self, x, y, k, index):
        s = control.switch(index, [_branch0, _branch1, _branch2], x, y, k)
        carried = (torch.zeros((), dtype=torch.long), x, torch.ones(x.shape[0], dtype=torch.bool))
        _, z, active = control.loop(lambda i, x, active, y: (i < 20) & active.any(), _steps,
                                    carried, y)
        (w,) = control.fori(3, _scaled, (x,), y)
        return (*s, z, active, w)


def test_switch_loop_and_fori_export_to_the_eager_results():
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)) for _ in range(2))
    k = torch.tensor(0.25)
    with control.export_tracing():
        ep = torch.export.export(_Flow(), (x, y, k, torch.tensor(0)), strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    served = torch.export.load(io.BytesIO(buf.getvalue())).module()
    for index in range(3):
        want = _Flow()(x, y, k, index)  # eagerly, an int index: no trace
        got = served(x, y, k, torch.tensor(index))
        for g, w in zip(got, want):
            assert torch.equal(g, w), index
    code = ep.graph_module.code
    assert "torch.ops.higher_order.cond" in code and "torch.ops.higher_order.while_loop" in code


def test_a_branch_closing_over_a_tensor_is_refused():
    x = torch.ones(3)

    class Closure(torch.nn.Module):
        def forward(self, a, index):
            return control.switch(index, [lambda a: a + x, lambda a: a - x], a)

    with pytest.raises(ValueError, match="closes over a tensor"), control.export_tracing():
        torch.export.export(Closure(), (x, torch.tensor(0)), strict=False)


# -- the sfm:: operators --------------------------------------------------------

def _op_cases():
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    cam = torch.from_numpy(rng.integers(0, 3, 8).astype(np.int32))
    q = f32(8, 4)
    q = q / q.norm(dim=-1, keepdim=True)
    X = f32(8, 3) + torch.tensor([0.0, 0.0, 6.0])
    return {
        "blur_levels": (f32(16, 20), [0.25, 0.5, 0.25, 0.1, 0.2, 0.4, 0.2, 0.1], [3, 5]),
        "candidate_response": (f32(5, 16, 16), 0.01, 10.0, 2),
        "candidate_block_max": (f32(5, 16, 24), 0.01, 10.0, 2),
        "match_top2": (f32(10, 128), f32(12, 128), torch.from_numpy(rng.random(12) < 0.8)),
        "ba_blocks": (cam, f32(8, 3), q, X, f32(8, 2), torch.ones(8), 3, 0.0),
        "expand_cam": (cam, f32(8, 21), f32(3, 7)),
        "reduce_cam": (f32(8, 21), f32(8, 3),
                       torch.from_numpy(rng.integers(0, 8, 12).astype(np.int32)),
                       torch.from_numpy(rng.random(12) < 0.7), 3),
        "cam_diag": (f32(8, 30), f32(5, 3, 3),
                     torch.from_numpy(rng.integers(0, 5, 8).astype(np.int32)),
                     torch.from_numpy(rng.integers(0, 8, 12).astype(np.int32)),
                     torch.from_numpy(rng.random(12) < 0.7), 3),
    }


OPS = ["ba_blocks", "blur_levels", "cam_diag", "candidate_block_max", "candidate_response",
       "expand_cam", "match_top2", "reduce_cam"]


@pytest.mark.parametrize("name", OPS)
def test_sfm_operator_passes_opcheck(name):
    """Fake implementation, schema and CPU implementation (the plain
    version) agree: ``torch.library.opcheck``."""
    kernels.register_ops()
    torch.library.opcheck(getattr(torch.ops.sfm, name).default, _op_cases()[name])
