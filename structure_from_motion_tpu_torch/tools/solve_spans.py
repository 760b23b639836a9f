"""Where the end-of-run solve's host time goes, by the program's spans.

    python3 -m structure_from_motion_tpu_torch.tools.solve_spans CHECKPOINT
        [--config JSON] [--solves 10]

Restores CHECKPOINT from an in-memory copy (``load_checkpoint`` of an
uncompressed npz) on the card and runs ``finalize_global(iterations=20)``
on it, every solve from the same restored state, as the end of a run does:
first two solves, then three pairs of ``--solves`` solves with the spans
(``utils/profiling.span``) off and on in turn (the shared host's speed
drifts within a run), then one solve with the spans on under
``torch.profiler``. Prints one JSON line:

* ``solve_s``: ``off`` and ``on``, each block's median wall seconds a
  solve (restore included);
* ``span_ms``: each span's name -> [ms, self ms, count] a solve, over the
  solves with the spans on;
* ``coverage``: [least, median] over those solves of the share of a solve's
  wall time that its ``checkpoint.load`` and ``global.solve`` cover
  (``solve_wall``), and of the share of ``global.solve`` that its children
  cover (``solve_children``);
* ``assembly_reads``: the host reads of the assembly and the packing a
  solve (``models/global_ba.host_reads``), over the blocks' solves;
* ``site_us``: a span site's cost, ``off`` and ``on`` (no profiler), each
  the median of five blocks' means of 10^5 entries, the two sides' blocks
  in turn;
* ``profiled``: the profiled solve's ``wall_s``, the union of its device
  operations (``busy_s``) and its idle seconds (``idle_gaps``) by the
  innermost span around each gap's middle ("host" where none is).

``--config`` is a ``PipelineConfig`` JSON, or a file that holds one under
``"pipeline"``; without it, the default configuration.
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import time

import numpy as np
import torch

from structure_from_motion_tpu_torch.utils import profiling


def _solve(eng, blob: bytes, iterations: int) -> float:
    """Wall seconds of one restore and global solve, the card drained."""
    t0 = time.perf_counter()
    eng.load_checkpoint(io.BytesIO(blob))
    eng.finalize_global(iterations=iterations)
    profiling.device_fence()
    return time.perf_counter() - t0


def site_us(n: int = 100_000) -> dict:
    """Microseconds of an empty span, off and on (no profiler): five blocks
    of ``n`` entries a side, off and on in turn (the shared host's speed
    drifts between blocks), each side the median of its blocks' means."""
    means = {"off": [], "on": []}
    for _ in range(5):
        for side in means:
            profiling.enable(side == "on")
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with profiling.span("site"):
                    pass
            means[side].append((time.perf_counter_ns() - t0) / n / 1e3)
            profiling.reset()
    profiling.enable(False)
    return {side: float(np.median(v)) for side, v in means.items()}


def span_summary(records: list, walls: list) -> dict:
    """``span_ms`` and ``coverage`` (see the module's docstring) of the
    records of solves whose wall seconds are ``walls``, in order."""
    roots = sorted((r for r in records if r.parent is None), key=lambda r: r.start_ns)
    loads = [r for r in roots if r.name == "checkpoint.load"]
    solves = [r for r in roots if r.name == "global.solve"]
    took, own, count = (collections.Counter() for _ in range(3))
    kids = collections.Counter()
    for r in records:
        took[r.name] += r.end_ns - r.start_ns
        own[r.name] += r.self_ns
        count[r.name] += 1
        kids[r.parent] += r.end_ns - r.start_ns
    wall, inner = [], []
    for load, solve, s in zip(loads, solves, walls):
        length = solve.end_ns - solve.start_ns
        wall.append(1e-9 * (load.end_ns - load.start_ns + length) / s)
        inner.append(kids[solve.id] / length)
    n = max(len(solves), 1)

    def spread(v):
        return [min(v), float(np.median(v))] if v else None

    return {"span_ms": {k: [1e-6 * took[k] / n, 1e-6 * own[k] / n, count[k] / n]
                        for k in sorted(took)},
            "coverage": {"solve_wall": spread(wall), "solve_children": spread(inner)}}


def idle_gaps(prof) -> dict:
    """``busy_s`` (the union of the device's operations) and ``idle_gaps``
    (each gap between them named by the innermost span around its middle)
    of a ``torch.profiler`` run."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == cpu and getattr(e, "is_user_annotation", False)]
    names = {s[2] for s in spans}
    merged = []
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == cuda and e.name not in names
                       and not getattr(e, "is_user_annotation", False)):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = collections.Counter()
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + start)
        around = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(around, key=lambda s: s[1] - s[0])[2] if around else "host"
        gaps[name] += 1e-6 * (start - end)
    return {"busy_s": 1e-6 * sum(b - a for a, b in merged),
            "idle_gaps": dict(gaps.most_common())}


def measure(blob: bytes, config, device: str = "cuda", iterations: int = 20,
            solves: int = 10, blocks: int = 3, warm: int = 2, site_n: int = 100_000) -> dict:
    """The module's report (its docstring) for the checkpoint bytes ``blob``
    under the ``PipelineConfig`` ``config``; leaves the spans off."""
    from structure_from_motion_tpu_torch.models import global_ba
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    eng = IncrementalSfM(config, np.eye(3), frontend="precomputed", device=device)
    profiling.enable(False)
    for _ in range(warm):
        _solve(eng, blob, iterations)
    off, on, records, walls = [], [], [], []
    reads = global_ba.host_reads
    try:
        for _ in range(blocks):
            off.append(float(np.median([_solve(eng, blob, iterations) for _ in range(solves)])))
            profiling.reset()
            profiling.enable(True)
            took = [_solve(eng, blob, iterations) for _ in range(solves)]
            profiling.enable(False)
            on.append(float(np.median(took)))
            records += profiling.records()
            walls += took
        reads = (global_ba.host_reads - reads) / (2 * blocks * solves)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiling.enable(True)
        with torch.profiler.profile(activities=acts) as prof:
            wall = _solve(eng, blob, iterations)
    finally:
        profiling.enable(False)
        profiling.reset()
    return dict(solve_s={"off": off, "on": on}, **span_summary(records, walls),
                assembly_reads=reads, site_us=site_us(site_n), profiled=dict(wall_s=wall, **idle_gaps(prof)))


def _load_config(path: str | None):
    from structure_from_motion_tpu_torch.config import PipelineConfig

    if path is None:
        return PipelineConfig()
    with open(path) as f:
        raw = json.load(f)
    return PipelineConfig.from_json(json.dumps(raw.get("pipeline", raw)))


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint")
    p.add_argument("--config", default=None)
    p.add_argument("--solves", type=int, default=10)
    a = p.parse_args()
    with np.load(a.checkpoint) as f:
        buf = io.BytesIO()
        np.savez(buf, **{k: np.array(f[k]) for k in f.files})
    out = measure(buf.getvalue(), _load_config(a.config), solves=a.solves)
    out["device"] = torch.cuda.get_device_name()
    print(json.dumps(out))
