"""Live against served frames: where a served frame's time goes.

    python3 -m structure_from_motion_tpu_torch.tools.serve_frames [--frames 16] [--device cuda]
        [--python-profile] [--trace DIR] [--report DIR] [--boxed-syncs]

Exports a fresh native engine's ``frame_step_native`` alone (the CLI's
default configuration on rendered 960x1280 frames on the card; a small
configuration at 240x320 with ``--device cpu``), loads it, and runs the same
frames through a live and a served engine, the two taking turns frame by
frame (the shared host's speed drifts within a run). It prints the wall
time of every frame between two synchronisations; the served/live ratio of
the mean steady frame (from frame 2 on, no loop graph captured by either
engine; more than 16 frames would need the eviction program); the host
synchronisations a frame (``torch.cuda.set_sync_debug_mode``; on the card
only), and those of the last steady frame by call site
(``tools/slice_frames.sync_site``); each frame's loop-mask reads, CUDA graph captures and replays
(``utils/control.stats``); the export's trace and save seconds, the
program's and artifact's bytes and the load seconds. The last frame of each
engine runs under ``torch.profiler``: the operators that took the most host
time and, on the card, device time, the split of the served frame's extra
time into device and host time, and the operators whose host time differs
most between the two. ``--trace DIR`` also writes those frames' timelines
and prints the host's time in and between the outermost operators, the
largest gaps, the device's idle time by the operator it waited on, and the
CUDA graph launches; ``--report DIR`` prints that report again from the
files. ``--python-profile``: one more frame of each under ``cProfile`` and
the Python functions whose own time differs most, and the export's save,
with its loop tags and again without them, under ``cProfile`` with the
garbage collector's passes and seconds. ``--boxed-syncs``: one more
served frame naming each node of the loaded program that synchronises
through its boxed ``OpOverload`` call (torch logs those to standard error,
with no Python frame to name). Prints one JSON line a run, then the
profiles.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import gzip
import io
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch


def _config(device: str):
    from structure_from_motion_tpu_torch.config import CapacityConfig
    from structure_from_motion_tpu_torch.tools.slice_frames import cli_default_config

    cfg = cli_default_config()
    if device == "cuda":
        return cfg, (960, 1280)
    return dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, max_keypoints=256, num_octaves=3,
                                          upsample_first_octave=False),
        capacity=CapacityConfig(max_views=8, max_keypoints=256, max_points=2048,
                                max_observations=8192)), (240, 320)


def _top(prof, sort: str, n: int) -> str:
    """The ``n`` first functions of a ``cProfile`` profile by ``sort``."""
    import io
    import pstats

    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats(sort).print_stats(n)
    return out.getvalue()


def _python_profile(engine, im, device: str):
    """One more frame under ``cProfile``: (the functions that took the most
    own time, with the frame's wall time and the time the profile accounts
    for, the profile)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    engine.process_image(im)
    if device == "cuda":
        torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    seen = pstats.Stats(prof).total_tt
    return (f"cProfile: frame {1e3 * wall:.3f} ms, of it accounted to Python functions "
            f"{1e3 * seen:.3f} ms\n" + _top(prof, "tottime", 25)), prof


@contextlib.contextmanager
def _collector():
    """Count the garbage collector's passes in the block: yields ``[passes
    of generation 0, 1, 2, seconds in the collector]``, filled as it runs."""
    seen, start = [0, 0, 0, 0.0], [0.0]

    def watch(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            seen[info["generation"]] += 1
            seen[3] += time.perf_counter() - start[0]
    gc.callbacks.append(watch)
    try:
        yield seen
    finally:
        gc.callbacks.remove(watch)


def _profiled_saves(save, sink: list):
    """``torch.export.save`` as the export calls it, under ``cProfile``;
    then the same program saved again with its loop tags dropped (into
    memory, also profiled). ``sink`` receives (label, profile, seconds,
    collector passes, collector seconds) for each."""
    import cProfile

    def one(label, ep, f):
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        try:
            with _collector() as seen:
                save(ep, f)
        finally:
            prof.disable()
        sink.append((label, prof, time.perf_counter() - t0, seen[:3], seen[3]))

    def run(ep, f, *args, **kwargs):
        if args or kwargs:
            raise TypeError("serve_frames profiles a save of (program, file) only")
        one("with the loop tags", ep, f)
        for _, gm in ep.graph_module.named_modules():
            if isinstance(gm, torch.fx.GraphModule):
                for node in gm.graph.nodes:
                    node.meta.pop("custom", None)
        one("without the loop tags", ep, io.BytesIO())
    return run


def _frames(engines: dict, imgs, device: str, traces: dict) -> dict:
    """Every frame through each engine of ``{name: engine}``, the engines
    taking turns frame by frame (the first one first on even frames, last
    on odd ones), so that both meet the same state of the shared host:
    ``{name: (wall s a frame, host synchronisations a frame, loop stats a
    frame, key_averages() of the last frame's profile)}``; ``traces``:
    ``{name: file}`` for the last frame's timeline (gzip Chrome trace)."""
    from structure_from_motion_tpu_torch.utils import control

    from structure_from_motion_tpu_torch.tools.slice_frames import host_syncs

    out = {name: ([], [], [], None) for name in engines}
    in_program = {name: [0.0] for name in engines}
    for name, engine in engines.items():  # the host time inside the frame program
        engine.programs["frame_step_native"] = _timed(engine.programs["frame_step_native"],
                                                      in_program[name])
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for i, im in enumerate(imgs):
        last = i == len(imgs) - 1
        order = list(engines) if i % 2 == 0 else list(reversed(engines))
        for name in order:
            times, syncs, loops, _ = out[name]
            sync()
            prof = torch.profiler.profile(activities=acts) if last else contextlib.nullcontext()
            counting = host_syncs() if device == "cuda" else contextlib.nullcontext({})
            with counting as sites, prof, _collector() as seen:
                control.reset_stats()
                in_program[name][0] = 0.0
                t0 = time.perf_counter()
                engines[name].process_image(im)
                sync()
                times.append(time.perf_counter() - t0)
                st = control.stats
                loops.append(dict(reads=st.reads, replays=st.replays, captures=st.captures,
                                  pool_bytes=st.pool_bytes, program_s=in_program[name][0],
                                  gc_passes=seen[:3], gc_s=seen[3]))
            syncs.append(dict(sites))
            if last:
                out[name] = (times, syncs, loops, prof.key_averages())
                if name in traces:
                    raw = traces[name].removesuffix(".gz")
                    prof.export_chrome_trace(raw)
                    with open(raw, "rb") as f, gzip.open(traces[name], "wb") as g:
                        shutil.copyfileobj(f, g)
                    os.remove(raw)
    return out


def _timed(fn, acc: list):
    """``fn``, adding the host seconds of each call to ``acc[0]``."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[0] += time.perf_counter() - t0
    return run


def _boxed_syncs(served, im) -> dict:
    """One more served frame with every node of the loaded programs that
    still calls its ``OpOverload`` (torch LOGS such a call's host
    synchronisation to standard error, with no Python frame) wrapped to
    watch the log: ``{"node name: operator": synchronisations}``."""
    import collections
    import sys

    found = collections.Counter()
    with tempfile.TemporaryFile() as log:

        def watch(name, op):
            def call(*args, **kwargs):
                before = os.fstat(log.fileno()).st_size
                out = op(*args, **kwargs)
                after = os.fstat(log.fileno()).st_size
                if after > before:
                    log.seek(before)
                    n = log.read(after - before).decode(errors="replace").count(
                        "called a synchronizing")
                    if n:
                        found[f"{name}: {op}"] += n
                return out
            return call

        for module in served._modules.values():
            for _, gm in module.named_modules():
                if isinstance(gm, torch.fx.GraphModule):
                    for node in gm.graph.nodes:
                        if node.op == "call_function" and isinstance(node.target,
                                                                     torch._ops.OpOverload):
                            node.target = watch(node.name, node.target)
                    gm.recompile()
        sys.stderr.flush()
        saved = os.dup(2)
        os.dup2(log.fileno(), 2)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            served.process_image(im)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
    return dict(found)


def _ops(avg) -> dict:
    """``{operator: (calls, own host us, own device us)}`` of a profile."""
    return {e.key: (e.count, e.self_cpu_time_total, e.self_device_time_total) for e in avg}


def _op_diff(live: dict, served: dict, n: int = 15) -> str:
    """The operators whose own host time differs most between the served
    and the live frame, with their calls."""
    rows = []
    for key in set(live) | set(served):
        lc, lt, _ = live.get(key, (0, 0.0, 0.0))
        sc, st, _ = served.get(key, (0, 0.0, 0.0))
        rows.append((st - lt, key, lc, sc, lt, st))
    rows.sort(key=lambda r: -abs(r[0]))
    lines = [f"  {d / 1e3:+9.3f} ms  calls {lc:6d} -> {sc:6d}  ({lt / 1e3:.3f} -> "
             f"{st / 1e3:.3f} ms)  {key[:70]}" for d, key, lc, sc, lt, st in rows[:n]]
    return "\n".join(lines)


def _fn_diff(live, served, n: int = 15) -> str:
    """The Python functions whose own time differs most between two
    ``cProfile`` profiles, with their calls."""
    import pstats

    a, b = pstats.Stats(live).stats, pstats.Stats(served).stats
    rows = []
    for key in set(a) | set(b):
        la, lb_ = a.get(key, (0, 0, 0.0, 0.0, None)), b.get(key, (0, 0, 0.0, 0.0, None))
        rows.append((lb_[2] - la[2], key, la[1], lb_[1], la[2], lb_[2]))
    rows.sort(key=lambda r: -abs(r[0]))
    return "\n".join(f"  {d * 1e3:+9.3f} ms  calls {lc:7d} -> {sc:7d}  ({lt * 1e3:.3f} -> "
                     f"{st * 1e3:.3f} ms)  {os.path.basename(key[0])}:{key[1]} {key[2]}"
                     for d, key, lc, sc, lt, st in rows[:n])


def _split(out: dict, ops: dict) -> dict:
    """The served frame's extra time against live: the ratio and difference
    of the two engines' mean steady frames (``steady_s``), and of the
    profiled frames the device time (every device event's own time) and
    the host rest of the difference."""
    dev = {k: sum(r[2] for r in ops[k].values()) / 1e6 for k in ops}
    extra = out["served"]["steady_s"] - out["live"]["steady_s"]
    return dict(ratio=out["served"]["steady_s"] / out["live"]["steady_s"], extra_s=extra,
                device_s=dev, extra_device_s=dev["served"] - dev["live"],
                extra_host_s=extra - (dev["served"] - dev["live"]),
                host_ops=(sum(r[0] for r in ops["live"].values()),
                          sum(r[0] for r in ops["served"].values())))


def _timeline(path: str) -> dict:
    """What one profiled frame's timeline (a gzip Chrome trace) shows on
    the thread that ran the frame: the host's time in operators (the
    outermost ``aten::`` / ``sfm::`` and CUDA runtime events) and between
    them (Python), the largest gaps between two operators with their
    neighbours, and the device's busy and idle time, the idle time before
    each kernel charged to the outermost operator that launched it."""
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]
    tid = max({e["tid"] for e in host}, key=lambda t: sum(e["tid"] == t for e in host))
    host = sorted((e for e in host if e["tid"] == tid), key=lambda e: (e["ts"], -e["dur"]))
    top, end = [], None  # the outermost events, in order
    launcher: dict = {}  # correlation id of a launch -> the outermost event around it
    for e in host:
        if end is None or e["ts"] >= end:
            top.append(e)
            end = e["ts"] + e["dur"]
        if e["cat"] != "cpu_op":
            launcher[e.get("args", {}).get("correlation")] = top[-1]["name"]
    in_ops = sum(e["dur"] for e in top)
    by_op: dict = {}  # outermost operator -> [calls, host us]
    for e in top:
        row = by_op.setdefault(e["name"], [0, 0.0])
        row[0] += 1
        row[1] += e["dur"]
    span = top[-1]["ts"] + top[-1]["dur"] - top[0]["ts"]
    gaps = sorted(((b["ts"] - (a["ts"] + a["dur"]), a["name"], b["name"])
                   for a, b in zip(top, top[1:])), reverse=True)
    device = sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                    key=lambda e: e["ts"])
    graph_of = {e["args"].get("correlation"): e for e in host if e["name"] == "cudaGraphLaunch"}
    graphs = {c: [e["dur"], 0] for c, e in graph_of.items()}  # host us, kernels
    idle_by: dict = {}
    busy, idle, dend = 0.0, 0.0, None
    for k in device:
        c = k.get("args", {}).get("correlation")
        if c in graphs:
            graphs[c][1] += 1
        if dend is not None and k["ts"] > dend:
            gap = k["ts"] - dend
            idle += gap
            name = launcher.get(k.get("args", {}).get("correlation"), "(no launch found)")
            idle_by[name] = idle_by.get(name, 0.0) + gap
        busy += k["dur"]
        dend = max(dend or 0.0, k["ts"] + k["dur"])
    return dict(span_us=span, ops_us=in_ops, n_ops=len(top), gaps=gaps, busy_us=busy,
                idle_us=idle, idle_by=idle_by, by_op=by_op,
                graphs=[graphs[c] for c in sorted(graphs, key=lambda c: graph_of[c]["ts"])])


def _timeline_report(live: str, served: str, n: int = 12) -> str:
    """The served frame's timeline against the live one's: the host's time
    in operators and between them, the largest gaps, the device's busy and
    idle time and which operators the device waited on."""
    lines, runs = [], {}
    for name, path in (("live", live), ("served", served)):
        t = runs[name] = _timeline(path)
        lines.append(
            f"{name} frame (profiled): host span {t['span_us'] / 1e3:.3f} ms, in "
            f"{t['n_ops']} outermost operators {t['ops_us'] / 1e3:.3f} ms, between them "
            f"{(t['span_us'] - t['ops_us']) / 1e3:.3f} ms (gaps over 50 us: "
            f"{sum(g for g, *_ in t['gaps'] if g > 50) / 1e3:.3f} ms in "
            f"{sum(g > 50 for g, *_ in t['gaps'])}); device busy {t['busy_us'] / 1e3:.3f} ms, "
            f"idle {t['idle_us'] / 1e3:.3f} ms between its first and last kernel")
        lines += [f"  gap {g / 1e3:8.3f} ms after {a[:50]} before {b[:50]}"
                  for g, a, b in t["gaps"][:n]]
        lines.append(f"  device idle by the operator that launched the next kernel:")
        lines += [f"  {us / 1e3:8.3f} ms  {k[:90]}"
                  for k, us in sorted(t["idle_by"].items(), key=lambda kv: -kv[1])[:n]]
        lines.append(f"  CUDA graph launches (host ms, kernels): "
                     + ", ".join(f"({us / 1e3:.3f}, {k})" for us, k in t["graphs"]))
    a, b = runs["live"]["by_op"], runs["served"]["by_op"]
    lines.append("outermost operators by the served frame's host time minus live's:")
    keys = sorted(set(a) | set(b), key=lambda k: -abs(b.get(k, [0, 0.0])[1] - a.get(k, [0, 0.0])[1]))
    for k in keys[:n]:
        (lc, lt), (sc, st) = a.get(k, [0, 0.0]), b.get(k, [0, 0.0])
        lines.append(f"  {(st - lt) / 1e3:+8.3f} ms  calls {lc:5d} -> {sc:5d}  ({lt / 1e3:.3f} -> "
                     f"{st / 1e3:.3f} ms)  {k[:60]}")
    return "\n".join(lines)


def _dispatch_us(device: str, reps: int = 2000) -> dict:
    """Host microseconds a call of some operators a frame program runs
    most, through the ``OpOverload`` a loaded program calls (the boxed
    path) and through the eager binding the live engine calls, on small
    tensors of ``device`` (no synchronisation): ``{operator: (boxed,
    eager)}``."""
    a = torch.rand(64, 4, device=device)
    b = torch.rand(64, 4, device=device)
    idx = torch.arange(8, device=device)
    aten = torch.ops.aten
    cases = {
        "mul": (lambda: aten.mul.Tensor(a, b), lambda: torch.mul(a, b)),
        "add": (lambda: aten.add.Tensor(a, b), lambda: torch.add(a, b)),
        "where": (lambda: aten.where.self(a > 0.5, a, b), lambda: torch.where(a > 0.5, a, b)),
        "select": (lambda: aten.select.int(a, 1, 2), lambda: torch.select(a, 1, 2)),
        "slice": (lambda: aten.slice.Tensor(a, 1, 0, 2), lambda: a[:, 0:2]),
        "view": (lambda: aten.view.default(a, [128, 2]), lambda: a.view(128, 2)),
        "unsqueeze": (lambda: aten.unsqueeze.default(a, 0), lambda: torch.unsqueeze(a, 0)),
        "index": (lambda: aten.index.Tensor(a, [idx]), lambda: a[idx]),
    }
    out = {}
    for name, fns in cases.items():
        times = []
        for fn in fns:
            for _ in range(100):
                fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append((time.perf_counter() - t0) / reps * 1e6)
            if device == "cuda":
                torch.cuda.synchronize()
        out[name] = tuple(times)
    return out


def run(frames: int, device: str, python_profile: bool = False, trace: str | None = None,
        boxed_syncs: bool = False) -> dict:
    from structure_from_motion_tpu_torch import serve
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    cfg, size = _config(device)
    imgs, K, _, _ = synthetic_scene_sequence(n_frames=frames, size=size, seed=3,
                                             loops=0.07 * frames)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip() if device == "cuda" else "cpu")
    fresh = IncrementalSfM(cfg, K, frontend="native", seed=0, device=device)
    fresh.image_shape, fresh.image_dtype = size, imgs[0].dtype
    stats: dict = {}
    saves: list = []
    save = torch.export.save
    if python_profile:  # the save step alone under cProfile
        torch.export.save = _profiled_saves(save, saves)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.sfm.npz")
        t0 = time.perf_counter()
        try:
            sizes = serve.export_engine(fresh, path, programs=["frame_step_native"],
                                        stats=stats)
        finally:
            torch.export.save = save
        export_s = time.perf_counter() - t0
        artifact_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        served = serve.load_engine(path, seed=0, device=device)
        load_s = time.perf_counter() - t0
    live = IncrementalSfM(cfg, K, frontend="native", seed=0, device=device)
    trace_s, save_s = stats["frame_step_native"]
    out = dict(card=card, export_s=export_s, trace_s=trace_s, save_s=save_s,
               program_bytes=sizes["frame_step_native"], artifact_bytes=artifact_bytes,
               load_s=load_s, eager_nodes=getattr(served, "eager_nodes", None))
    ops, tables, pys, traces = {}, {}, {}, {}
    engines = {"live": live, "served": served}
    if trace:
        os.makedirs(trace, exist_ok=True)
        traces = {name: os.path.join(trace, f"serve_frames_{name}.json.gz") for name in engines}
    runs = _frames(engines, imgs[:-1], device, traces)
    # the steady frames: from frame 2 on, not the profiled last one, and none
    # in which either engine captured a loop graph
    steady = [i for i in range(2, len(imgs) - 2)
              if not any(runs[name][2][i]["captures"] for name in engines)]
    out["steady_frames"] = steady
    for name, engine in engines.items():
        times, syncs, loops, avg = runs[name]
        out[name] = dict(median_s=float(np.median(times[2:-1])),
                         steady_s=float(np.mean([times[i] for i in steady])), times_s=times,
                         syncs=[sum(f.values()) for f in syncs], loops=loops,
                         sites={f"frame {i}": syncs[i] for i in steady[-1:]})
        ops[name] = _ops(avg)
        tables[name] = avg.table(sort_by="self_cpu_time_total", row_limit=12)
        if device == "cuda":
            tables[name] += (f"\ndevice time {sum(r[2] for r in ops[name].values()) / 1e3:.3f} "
                             "ms in all; by device time:\n"
                             + avg.table(sort_by="self_cuda_time_total", row_limit=12))
        if python_profile:
            text, pys[name] = _python_profile(engine, imgs[-1], device)
            tables[name] += "\n" + text
    out["same_bits"] = all(torch.equal(a, b) for a, b in zip(live.state, served.state))
    if boxed_syncs and device == "cuda":
        out["boxed_syncs"] = _boxed_syncs(served, imgs[-1])
    out["same_reads"] = ([f["reads"] for f in out["live"]["loops"]]
                         == [f["reads"] for f in out["served"]["loops"]])
    out["split"] = _split(out, ops)
    print(json.dumps(out))
    for name, table in tables.items():
        print(f"{name}, last frame, by host time:\n{table}")
    sp = out["split"]
    print(f"served/live steady frame {sp['ratio']:.4f} ({out['served']['steady_s']:.4f} against "
          f"{out['live']['steady_s']:.4f} s, the mean of frames {steady}; medians of frames 2-"
          f"{len(imgs) - 3} {out['served']['median_s']:.4f} against {out['live']['median_s']:.4f}"
          f" s): extra {1e3 * sp['extra_s']:.3f} ms, of which device "
          f"{1e3 * sp['extra_device_s']:.3f} ms (profiled frames: live {1e3 * sp['device_s']['live']:.3f}"
          f", served {1e3 * sp['device_s']['served']:.3f} ms) and host {1e3 * sp['extra_host_s']:.3f}"
          f" ms; operator calls in the profiled frame live {sp['host_ops'][0]}, served "
          f"{sp['host_ops'][1]} ({card})")
    for name in engines:
        loops = [out[name]["loops"][i] for i in steady]
        print(f"{name}, steady frames: {1e3 * out[name]['steady_s']:.3f} ms a frame, of it "
              f"{1e3 * np.mean([f['program_s'] for f in loops]):.3f} ms in the frame program's "
              f"call (host), {1e3 * np.mean([f['gc_s'] for f in loops]):.3f} ms in the garbage "
              f"collector ({np.mean([f['gc_passes'] for f in loops], axis=0).tolist()} passes "
              f"by generation) ({card})")
    cost = _dispatch_us(device)
    extra_us = float(np.mean([boxed - eager for boxed, eager in cost.values()]))
    print("host us a call, boxed OpOverload against the eager binding: "
          + ", ".join(f"{k} {b_:.2f} / {e:.2f}" for k, (b_, e) in cost.items())
          + f"; +{extra_us:.2f} us a call on the mean ({card})")
    print("operators by the served frame's own host time minus live's (profiled frames):\n"
          + _op_diff(ops["live"], ops["served"]))
    if pys:
        print("Python functions by the served frame's own time minus live's (cProfile):\n"
              + _fn_diff(pys["live"], pys["served"]))
    if traces:
        print(_timeline_report(traces["live"], traces["served"]))
    for label, prof, seconds, passes, gc_s in saves:
        print(f"the export's save {label} (profiled, so slower than save_s): {seconds:.2f} s, "
              f"collector passes by generation {passes}, {gc_s:.2f} s in the collector; by "
              "cumulative time:\n" + _top(prof, "cumulative", 30))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.add_argument("--python-profile", action="store_true",
                   help="also run one more frame of each, and the save (with and without the "
                        "loop tags), under cProfile")
    p.add_argument("--trace", default=None,
                   help="directory for the profiled frames' timelines (gzip Chrome traces); "
                        "prints the host's time in and between operators and where the device "
                        "waited on the host")
    p.add_argument("--report", default=None,
                   help="only print the report of the timelines an earlier --trace wrote to "
                        "this directory")
    p.add_argument("--boxed-syncs", action="store_true",
                   help="one more served frame, naming the loaded program's nodes that "
                        "synchronise through their boxed OpOverload call (card only)")
    a = p.parse_args()
    if a.report:
        print(_timeline_report(*(os.path.join(a.report, f"serve_frames_{name}.json.gz")
                                 for name in ("live", "served"))))
    else:
        run(a.frames, a.device, a.python_profile, a.trace, a.boxed_syncs)
