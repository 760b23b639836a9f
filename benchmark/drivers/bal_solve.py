"""Closed-loop self-calibrating solves of a BAL problem drawn from the seed.

Traffic parameters (``traffic/<name>.json``): ``iterations``, the LM
iterations of a solve; ``warm_solves``, the solves of the set-up. The
configuration gives the problem's ``counts`` and, under ``assumed``, the
settings of ``reference/bal_scene.py`` that draws it.

Set-up draws the problem from ``--seed`` on the device (the "-pre" start,
BAL's convention) into pinned host memory and runs the warm solves. A
solve of the window, again and again from the same host arrays: the
upload and the change of convention (``io/bal.to_problem``), the port's
``models/global_ba.solve_global`` with the 10-wide camera block, then the
refined cameras (pose and intrinsics, (V, 9)) and points ((M, 3)) fetched
back: ``io/bal.from_state`` on the device and one copy each into pinned
host buffers made in set-up, waited for. The window counts whole solves.

What is judged, after the window: every solve's cost trajectory against
the plain float64 LM of ``reference/bal_ba.py`` on the same arrays on the
card: ``cost0_gap``, the first cost (the distortion, the intrinsics and
kernel B4), and ``cost_gap``, the largest relative gap of the costs. The
refined intrinsics' gap is reported beside. ``--control 1`` runs that
reference computed in TF32 in the program's place.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.reference import bal_ba as ref
from benchmark.reference import bal_scene


def settings(config: dict) -> dict:
    """The scene's settings: the numbers under the configuration's
    ``assumed``."""
    return {k: v["value"] for k, v in config["assumed"].items()
            if isinstance(v["value"], (int, float, list))}


def run(ctx) -> dict:
    from structure_from_motion_tpu_torch.io import bal
    from structure_from_motion_tpu_torch.models import global_ba
    from structure_from_motion_tpu_torch.utils import profiling

    tr, tf, dev = ctx.trace, ctx.traffic, ctx.device
    phases = {"imports": time.perf_counter() - ctx.start}
    t_phase = time.perf_counter()
    iters = int(tf["iterations"])
    n = ctx.config["counts"]
    V, M = int(n["cameras"]), int(n["points"])
    d = bal_scene.draw(ctx.seed, V, M, int(n["observations"]), settings(ctx.config), dev)
    pin = dev.type == "cuda"
    host = bal.BALProblem(*(d[k].cpu().pin_memory() if pin else d[k].cpu()
                            for k in ("cameras", "points", "cam", "point", "xy")))
    del d
    phases["draw"] = time.perf_counter() - t_phase
    ba = ctx.pipeline.ba
    stats: dict = {}

    if ctx.control:  # the reference in TF32, in the program's place
        p32 = ref.as_problem(*host, dev, torch.float32)

        def solve():
            out = ref.solve(p32, iters, dataclasses.asdict(ba), "tf32")
            return out["costs"], [], out["intr"]
    else:
        cams_host = torch.empty((V, 9), dtype=torch.float64, pin_memory=pin)
        pts_host = torch.empty((M, 3), dtype=torch.float64, pin_memory=pin)

        def solve():
            out, costs = global_ba.solve_global(bal.to_problem(host, dev), ba, iterations=iters,
                                                stats=stats)
            cams, pts = bal.from_state(out, M)
            cams_host.copy_(cams, non_blocking=pin)
            pts_host.copy_(pts, non_blocking=pin)
            if pin:
                torch.cuda.current_stream().synchronize()
            return np.asarray(costs, np.float64), list(stats["cg_iterations"]), \
                cams_host[:, 6:9].numpy().copy()

    t_phase = time.perf_counter()
    for _ in range(int(tf["warm_solves"])):
        solve()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    phases["warm solves"] = time.perf_counter() - t_phase
    spans = tr.on and not ctx.control
    if spans:
        profiling.reset()
        profiling.enable(True)
    runs, cg, intr, ends = [], [], None, []
    window_start = time.perf_counter()
    ctx.window_started(window_start)
    deadline = window_start + ctx.seconds
    while time.perf_counter() < deadline:
        costs, its, intr = solve()
        ends.append(time.perf_counter())
        runs.append(costs)
        cg.append(sum(its))
    window = time.perf_counter() - window_start
    each = np.diff([window_start] + ends)
    out = {"attempted": len(runs), "failed": int(sum(not np.all(np.isfinite(c)) for c in runs)),
           "e2e": {"global_solve_s": window / max(len(runs), 1)}}
    if spans:
        from benchmark import trace as tracing

        tr.context["program_spans"] = profiling.records()
        profiling.enable(False)
        tr.context["cg_per_solve"] = cg
        torch.cuda.synchronize()
        with tracing.profile() as prof:
            t0 = time.perf_counter()
            with tr.span("bal_solve"):
                solve()
            torch.cuda.synchronize()
            profiled = time.perf_counter() - t0
        tr.device = tracing.read_profile(prof, profiled)
        out["busy_s"] = tr.device["union_s"]
        tr.context["profiled_steps"] = 1
    out["memory_peak_bytes"] = ctx.memory_peak()
    if not ctx.control:
        tr.context.update(slots=stats.get("slots"), n_cams=V, n_obs=stats.get("obs"),
                          cam_slots=stats.get("cam_slots"), obs=stats.get("obs"),
                          cam_width=stats.get("cam_width"))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the reference: the plain float64 LM of the same arrays, on the card
    t_judge = time.perf_counter()
    truth = ref.solve(ref.as_problem(*host, dev), iters, dataclasses.asdict(ba), "f64")
    rc = truth["costs"]
    gaps = [np.abs(c - rc) / rc for c in runs]
    out["numbers"] = {
        "cost0_gap": float(max(g[0] for g in gaps)) if gaps else np.inf,
        "cost_gap": float(max(g.max() for g in gaps)) if gaps else np.inf,
    }
    di = np.abs(intr - truth["intr"]) if intr is not None else None
    out["info"] = {"intr_gap": None if di is None else {
                       "f_rel": float((di[:, 0] / truth["intr"][:, 0]).max()),
                       "k1": float(di[:, 1].max()), "k2": float(di[:, 2].max())},
                   "solves": len(runs), "reference_costs": rc.tolist(),
                   "program_costs": runs[-1].tolist() if runs else None,
                   "cg_per_solve": cg[:3], "setup_phases_s": phases,
                   "judge_s": time.perf_counter() - t_judge,
                   "camera_view": {"cam_slots": stats.get("cam_slots"), "obs": stats.get("obs"),
                                   "slots": stats.get("slots"),
                                   "cam_tiers": [list(t) for t in stats.get("cam_tiers", ())]},
                   "solve_s_quartiles": np.percentile(each, [25, 50, 75]).tolist()
                   if len(each) else None}
    return out
