"""A steady frame as the CUDA graph runs it, held on the CPU.

On the card every steady frame (slot >= 2) is one replay of one CUDA graph
(``models/incremental._frame_step`` through ``utils/control.graphed``):
the PnP, triangulation and BA bucket switches are IF nodes decided on the
device, the LM loops WHILE nodes stopped on the device. No graph can be
captured here, so ``control.device_form`` runs the same frames with the
graph's semantics: every branch of every switch runs and the indexed one's
outputs are kept, every loop runs every chunk, and nothing reads the host.
These tests hold that form to the eager frames, bit for bit in every state
field, statistic and archive record: a slide run with one eviction, and
the batched engine at B = 2. (The JAX engine is the oracle of the device
form in ``tests/test_torch_slice.py``; ``chip_smoke.py`` phase 13 holds the
captured graphs to eager frames on the card.)"""

import dataclasses

import numpy as np
import torch

from structure_from_motion_tpu_torch.models import incremental
from structure_from_motion_tpu_torch.models.batched import BatchedIncrementalSfM
from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
from structure_from_motion_tpu_torch.models.tracks import SfMState
from structure_from_motion_tpu_torch.utils import control
from tests.test_incremental import pipeline_config, synthetic_sequence  # noqa: F401
from tests.test_torch_config import port_config


def _config(pipeline_config, **changes):
    """``tests/test_incremental.pipeline_config`` for the port with fewer
    RANSAC hypotheses and LM steps (the device form runs every PnP rung's
    and every loop to its cap) and ``changes``."""
    return port_config(dataclasses.replace(
        pipeline_config, fundamental_ransac=dataclasses.replace(
            pipeline_config.fundamental_ransac, iteration=64),
        pnp_ransac=dataclasses.replace(pipeline_config.pnp_ransac, iteration=128),
        pnp_lm=dataclasses.replace(pipeline_config.pnp_lm, iterations=30),
        triangulation_lm=dataclasses.replace(pipeline_config.triangulation_lm, iterations=20),
        **changes))


def _rung_calls(monkeypatch) -> dict:
    """Count the PnP and BA rungs run (both ladders have several rungs at
    ``pipeline_config``'s capacities: 2 and 4)."""
    calls = {"pnp": 0, "ba": 0}
    for name, key in (("_pnp_rung", "pnp"), ("_ba_rung", "ba")):
        fn = getattr(incremental, name)

        def counted(*args, _fn=fn, _key=key, **kwargs):
            calls[_key] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(incremental, name, counted)
    return calls


def _frames(engine, feed, frames, form: bool):
    """Every frame through ``engine`` (in ``control.device_form`` when
    ``form``) -> (states a frame, statistics a frame, stop-mask reads)."""
    states, infos = [], []
    control.reset_stats()
    for f in frames:
        if form:
            with control.device_form():
                info = feed(engine, f)
        else:
            info = feed(engine, f)
        states.append([t.clone() for t in engine.state])
        infos.append(info)
    return states, infos, control.stats.reads


def _same(a, b) -> None:
    (sa, ia, _), (sb, ib, _) = a, b
    for t, (x, y) in enumerate(zip(sa, sb)):
        for f, u, w in zip(SfMState._fields, x, y):
            assert torch.equal(u, w), f"frame {t} state.{f}"
    for t, (x, y) in enumerate(zip(ia, ib)):
        assert list(x) == list(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]),
                                          err_msg=f"frame {t} {k}")


def test_device_form_frames_equal_eager_frames(pipeline_config, monkeypatch):  # noqa: F811
    """A slide run of 4 frames with window 3 (frame 3 evicts): the device
    form's states, statistics and archive record equal the eager run's, bit
    for bit; the device form ran every PnP and BA rung of every steady frame
    (the smallest BA rung too small for the map it is handed) and read no
    stop mask, where the eager run read them and ran one rung a switch."""
    K, frames, _, _, _ = synthetic_sequence(n_views=4, n_points=300, seed=2, noise=0.4)
    cap = dataclasses.replace(pipeline_config.capacity, max_points=1024, max_observations=4096)
    cfg = _config(pipeline_config, window_size=3, window_mode="slide", capacity=cap)
    pnp_rungs = len(incremental._pnp_ladder(cfg))
    ba = incremental._ba_ladder(cfg.capacity.max_points, cfg.capacity.max_observations)
    ba_rungs = len(ba)
    assert pnp_rungs == 2 and ba_rungs == 3
    feed = lambda e, f: e.process_features(*f)  # noqa: E731
    calls = _rung_calls(monkeypatch)
    eager_engine = IncrementalSfM(cfg, K, frontend="precomputed", device="cpu")
    eager = _frames(eager_engine, feed, frames, form=False)
    assert calls == {"pnp": 2, "ba": 2} and eager[2] > 0
    calls.update(pnp=0, ba=0)
    form_engine = IncrementalSfM(cfg, K, frontend="precomputed", device="cpu")
    device = _frames(form_engine, feed, frames, form=True)
    assert calls == {"pnp": 2 * pnp_rungs, "ba": 2 * ba_rungs} and device[2] == 0
    _same(device, eager)
    assert int(eager_engine.state.num_points) > ba[-1][0]
    assert len(form_engine._archive) == len(eager_engine._archive) == 1
    for a, b in zip(form_engine._archive[0], eager_engine._archive[0]):
        np.testing.assert_array_equal(a, b)


def test_device_form_batched_lanes_equal_eager_lanes(pipeline_config):  # noqa: F811
    """``BatchedIncrementalSfM`` at B = 2 (two sequences, one switch for
    both lanes on their largest counts): the device form's frames equal the
    eager frames, bit for bit, with no stop mask read."""
    seqs = [synthetic_sequence(n_views=4, n_points=200, seed=s, noise=0.4) for s in (2, 3)]
    K = seqs[0][0]
    cfg = _config(pipeline_config)
    frames = [tuple(np.stack([s[1][t][i] for s in seqs]) for i in range(3)) for t in range(4)]
    feed = lambda e, f: e.process_features(*f)  # noqa: E731
    eager = _frames(BatchedIncrementalSfM(cfg, K, batch=2, frontend="precomputed", seed=[0, 1],
                                          device="cpu"), feed, frames, form=False)
    device = _frames(BatchedIncrementalSfM(cfg, K, batch=2, frontend="precomputed", seed=[0, 1],
                                           device="cpu"), feed, frames, form=True)
    assert eager[2] > 0 and device[2] == 0
    _same(device, eager)


def test_a_steady_frame_is_one_graphed_call(pipeline_config, monkeypatch):  # noqa: F811
    """Frames 0 and 1 run as they are; every later frame is one
    ``control.graphed`` call of the whole frame, its slot a 0-dim tensor and
    its draws every rung's, drawn before the call (so that one key serves
    every steady frame of the engine), its graph kept in the engine's own
    dict."""
    K, frames, _, _, _ = synthetic_sequence(n_views=4, n_points=200, seed=2, noise=0.4)
    cfg = _config(pipeline_config)
    keys = []
    graphed = incremental.graphed

    def spy(fn, *operands, calls):
        st, slot, draws, _ = operands if len(operands) == 4 else (None, None, None, None)
        if st is not None and torch.is_tensor(slot) and fn.keywords.get("stage") == 2:
            keys.append((slot.dim(), type(draws).__name__, len(draws.pnp), len(draws.boot),
                         calls is engine._graphs))
        return graphed(fn, *operands, calls=calls)

    monkeypatch.setattr(incremental, "graphed", spy)
    engine = IncrementalSfM(cfg, K, frontend="precomputed", device="cpu")
    for f in frames:
        engine.process_features(*f)
    assert keys == [(0, "FrameDraws", 2, 0, True)] * 2
