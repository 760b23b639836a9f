"""The port's spans (``utils/profiling.span``): off, a span records nothing
and opens no profiler range; on, spans nest with their parents and roots,
lie on ``torch.profiler``'s timeline, and stay out of CUDA graph captures
and exported programs; the global solve, the restore and the frames record
the spans their docstrings name, on the CPU."""

import collections
import dataclasses
import time

import numpy as np
import pytest
import torch

from structure_from_motion_tpu_torch.io.synthetic import synthetic_sequence
from structure_from_motion_tpu_torch.models.batched import BatchedIncrementalSfM
from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
from structure_from_motion_tpu_torch.tools import solve_spans
from structure_from_motion_tpu_torch.utils import control, profiling
from tests.test_torch_batched import _cfg

GLOBAL = ("global.build", "global.pack", "global.lm", "global.fetch", "global.write_back")


@pytest.fixture(autouse=True)
def _tracing_restored():
    """Each test starts with tracing off and no records, and leaves it so."""
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _no_range(monkeypatch):
    """Entering a profiler range raises."""
    def refuse(*_, **__):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def _took(r) -> int:
    return r.end_ns - r.start_ns


def test_tracing_off_records_nothing_and_opens_no_range(monkeypatch):
    _no_range(monkeypatch)
    assert profiling.span("a") is profiling.span("b")  # one shared null context
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("a"):
            with profiling.span("b"):
                torch.ones(3).sum()
    assert profiling.records() == []


def test_spans_nest_with_their_parents_roots_and_self_time():
    profiling.enable(True)
    with profiling.span("solve"):
        with profiling.span("build"):
            time.sleep(0.002)
        with profiling.span("lm"):
            for _ in range(2):
                with profiling.span("iteration"):
                    time.sleep(0.001)
    with profiling.span("restore"):
        pass
    recs = profiling.records()
    assert [r.name for r in recs] == ["build", "iteration", "iteration", "lm", "solve", "restore"]
    by = {r.id: r for r in recs}
    solve, restore = recs[4], recs[5]
    assert solve.parent is None and solve.root == solve.id
    assert restore.parent is None and restore.root == restore.id != solve.id
    assert [by[r.parent].name for r in recs[:4]] == ["solve", "lm", "lm", "solve"]
    assert all(r.root == solve.id for r in recs[:5])
    for r in recs:
        kids = [c for c in recs if c.parent == r.id]
        assert r.self_ns == _took(r) - sum(_took(c) for c in kids)
        assert all(r.start_ns <= c.start_ns <= c.end_ns <= r.end_ns for c in kids)
    assert recs[0].self_ns >= 2_000_000
    profiling.reset()
    assert profiling.records() == []


def test_spans_lie_on_the_profilers_timeline():
    """Under ``torch.profiler``, each span is a user annotation of its name
    that holds the operations run inside it."""
    profiling.enable(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(64).sum()
    events = prof.events()
    marks = {e.name: e for e in events if e.name in ("outer", "inner")}
    assert set(marks) == {"outer", "inner"}
    assert all(getattr(e, "is_user_annotation", True) for e in marks.values())
    outer, inner = marks["outer"].time_range, marks["inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    sums = [e for e in events if e.name == "aten::sum"]
    assert sums and inner.start <= sums[0].time_range.start <= inner.end
    assert [r.name for r in profiling.records()] == ["inner", "outer"]


@pytest.mark.parametrize("where", ["capture", "export"])
def test_no_span_inside_a_capture_or_an_export(monkeypatch, where):
    """While the current stream captures a CUDA graph (stood in for on the
    CPU) or ``torch.export`` traces, a span records nothing and opens no
    range."""
    profiling.enable(True)
    _no_range(monkeypatch)
    if where == "capture":
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    else:
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
        assert control.exporting()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("a"):
            with profiling.span("b"):
                pass
    assert profiling.records() == []


class _Spanned(torch.nn.Module):
    def forward(self, x, y, floor):
        with profiling.span("outer"):
            with profiling.span("inner"):
                z = x * 2.0
            start = torch.ones_like(x, dtype=torch.bool)
            return z, control.masked_loop(40, 8, _halving, (start, x), y, floor)[1]


def _halving(active, x, y, floor):
    new = 0.5 * (x + y)
    x = torch.where(active, new, x)
    return active & ((new - y).abs() > floor), x


def test_an_exported_program_holds_no_profiler_operation():
    """A function with spans (and a masked loop, whose stop-mask reads are
    spans when run live), exported with tracing on as ``test_torch_loops``
    exports its loops: no ``profiler`` operator in the graph, no record;
    run live, the same function records its spans."""
    profiling.enable(True)
    x, y, floor = torch.linspace(1.0, 8.0, 6), torch.zeros(6), torch.tensor(1e-3)
    with control.export_tracing():
        ep = torch.export.export(_Spanned(), (x, y, floor), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert not any("profiler" in t or "record_function" in t for t in targets), targets
    assert "profiler" not in ep.graph_module.code
    assert profiling.records() == []
    _Spanned()(x, y, floor)
    names = collections.Counter(r.name for r in profiling.records())
    assert names["outer"] == names["inner"] == 1 and names["loop.read"] >= 1


@pytest.fixture(scope="module")
def slide_run(tmp_path_factory):
    """An 8-frame slide run through a window of 5 (128 keypoints) with
    tracing on and its frame spans, then its global solve by PCG (from 4
    cameras) with its spans and the loops' host reads, and the checkpoint
    it was solved from."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = dataclasses.replace(_cfg(128), window_size=5, window_mode="slide")
        K, frames, *_ = synthetic_sequence(n_views=8, n_points=120, kp_cap=128, seed=2)
        eng = IncrementalSfM(cfg, K, frontend="precomputed", device="cpu")
        profiling.reset()
        profiling.enable(True)
        for f in frames:
            eng.process_features(*f)
        frame_spans = profiling.records()
        pcg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, pcg_fallback_cameras=4))
        solver = IncrementalSfM(pcg, K, frontend="precomputed", device="cpu")
        solver.state, solver._frame, solver._archive = eng.state, eng._frame, eng._archive
        path = str(tmp_path_factory.mktemp("slide") / "pre_solve.npz")
        solver.save_checkpoint(path)
        with open(path, "rb") as f:
            blob = f.read()
        profiling.reset()
        reads = control.stats.reads
        info = solver.finalize_global(iterations=3)
        return dict(frames=frame_spans, solve=profiling.records(), info=info,
                    reads=control.stats.reads - reads, n_frames=len(frames), window=5,
                    checkpoint=blob, config=pcg)
    finally:
        profiling.enable(False)
        profiling.reset()
        torch.set_num_threads(n)


def test_global_solve_spans(slide_run):
    """Every ``global.*`` span once under the one ``global.solve`` root, its
    children over 95% of it, one ``ba.iteration`` an LM iteration, a
    ``pcg.read`` for each host read of the PCG's stop mask and a
    ``pcg.count_read`` for each count."""
    recs, info = slide_run["solve"], slide_run["info"]
    names = collections.Counter(r.name for r in recs)
    assert names["global.solve"] == 1 and all(names[n] == 1 for n in GLOBAL), names
    root = next(r for r in recs if r.name == "global.solve")
    assert root.parent is None and all(r.root == root.id for r in recs)
    kids = [r for r in recs if r.parent == root.id]
    assert sorted(r.name for r in kids) == sorted(GLOBAL)
    assert sum(_took(r) for r in kids) >= 0.95 * _took(root)
    assert len(info["cg_iterations"]) == 3 and min(info["cg_iterations"]) > 0
    assert names["ba.iteration"] == 3
    assert names["pcg.read"] == slide_run["reads"] >= 3
    assert names["pcg.count_read"] == len(info["cg_iterations"])
    lm = next(r for r in recs if r.name == "global.lm")
    by = {r.id: r for r in recs}
    for r in recs:
        if r.name in ("ba.iteration", "pcg.read", "pcg.count_read"):
            assert lm.start_ns <= r.start_ns and r.end_ns <= lm.end_ns
            up = r
            while up.parent != lm.id:
                up = by[up.parent]
            assert up.name in ("ba.iteration", "global.lm")


def test_solve_spans_tool(slide_run):
    """``tools/solve_spans`` over the run's checkpoint: every span of the
    restore and the solve a solve, both covering each solve's wall time and
    the children ``global.solve``, a site's cost off and on, no device
    operation (and so no idle gap) on the CPU, and the spans left off."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = solve_spans.measure(slide_run["checkpoint"], slide_run["config"], "cpu",
                                  iterations=2, solves=2, blocks=1, warm=1, site_n=1000)
    finally:
        torch.set_num_threads(n)
    assert len(out["solve_s"]["off"]) == len(out["solve_s"]["on"]) == 1
    ms = out["span_ms"]
    for name in ("checkpoint.load", "global.solve") + GLOBAL:
        took, own, count = ms[name]
        assert count == 1 and 0 <= own <= took, (name, ms[name])
    assert ms["ba.iteration"][2] == 2 and ms["pcg.count_read"][2] == 2
    assert min(out["coverage"]["solve_wall"]) >= 0.95
    assert min(out["coverage"]["solve_children"]) >= 0.95
    assert 0 < out["site_us"]["off"] < out["site_us"]["on"]
    assert out["assembly_reads"] == 3
    assert out["profiled"]["wall_s"] > 0
    assert out["profiled"]["busy_s"] == 0 and out["profiled"]["idle_gaps"] == {}
    with profiling.span("after"):
        pass
    assert profiling.records() == []


def test_frame_spans(slide_run):
    """A ``frame`` root a frame, with its upload, step and fetch; frames past
    the window also evict."""
    recs = slide_run["frames"]
    roots = [r for r in recs if r.name == "frame"]
    assert len(roots) == slide_run["n_frames"]
    for i, root in enumerate(sorted(roots, key=lambda r: r.start_ns)):
        kids = collections.Counter(r.name for r in recs if r.parent == root.id)
        want = {"frame.upload": 1, "frame.step": 1, "frame.fetch": 1}
        if i >= slide_run["window"]:
            want["frame.evict"] = 1
        assert kids == want, (i, kids)
    assert all(r.root in {x.id for x in roots} for r in recs)


def test_checkpoint_restore_span(tmp_path):
    """``load_checkpoint`` is one ``checkpoint.load`` root."""
    eng = IncrementalSfM(_cfg(64), np.eye(3), frontend="precomputed", device="cpu")
    path = str(tmp_path / "engine.npz")
    eng.save_checkpoint(path)
    profiling.enable(True)
    eng.load_checkpoint(path)
    recs = profiling.records()
    assert [r.name for r in recs] == ["checkpoint.load"] and recs[0].parent is None


def test_batched_frame_spans():
    """A lane batch's frame: a ``frame`` root with its upload, step and fetch."""
    cfg = _cfg(64)
    K, frames, *_ = synthetic_sequence(n_views=2, n_points=60, kp_cap=64, seed=1)
    eng = BatchedIncrementalSfM(cfg, K, batch=2, frontend="precomputed", device="cpu")
    profiling.enable(True)
    for f in frames:
        eng.process_features(*(np.stack([a, a]) for a in f))
    recs = profiling.records()
    roots = [r for r in recs if r.name == "frame"]
    assert len(roots) == 2
    for root in roots:
        kids = sorted(r.name for r in recs if r.parent == root.id)
        assert kids == ["frame.fetch", "frame.step", "frame.upload"]
