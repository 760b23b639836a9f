"""Closed-loop end-of-run solves: one restore of the pre-solve state from an
in-memory copy, then ``IncrementalSfM.finalize_global(iterations)``, again
and again.

Traffic parameters (``traffic/<name>.json``): ``checkpoint``, the engine
checkpoint under ``benchmark/data/`` that holds the pre-solve state, solved
as it is stored (the seed changes nothing: every run solves the same
problem); ``iterations``; ``warm_solves``, the solves of the set-up.

Set-up loads the checkpoint, writes its arrays into an uncompressed
in-memory npz (the copy every restore reads) and runs the warm solves (the
PCG's chunk graphs are captured there). The window counts whole solves,
each restore included.

What is judged: the cost trajectory of every solve of the window against
the plain float64 solve of ``reference/global_ba.py`` on the same arrays
(its refined camera centres are reported beside, not judged: the
program's PCG and the reference's exact solve part by as much as the TF32
control does, 2.5e-3 to 3.1e-3 of the span).
"""

from __future__ import annotations

import dataclasses
import io
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import geometry
from benchmark.reference import global_ba as ref

DATA = Path(__file__).resolve().parents[1] / "data"


def pre_solve_arrays(traffic: dict) -> dict:
    """The checkpoint's arrays, as stored."""
    with np.load(DATA / traffic["checkpoint"]) as f:
        return {k: np.array(f[k]) for k in f.files}


def run(ctx) -> dict:
    from structure_from_motion_tpu_torch.models import global_ba
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    tr, tf = ctx.trace, ctx.traffic
    phases = {"imports": time.perf_counter() - ctx.start}
    t_phase = time.perf_counter()
    iters = int(tf["iterations"])
    data = pre_solve_arrays(tf)
    buf = io.BytesIO()
    np.savez(buf, **data)
    blob = buf.getvalue()
    ba = dataclasses.asdict(ctx.pipeline.ba)
    if ctx.control:  # the reference in TF32, in the program's place
        p = ref.to_problem(ref.assemble(data), ctx.device, torch.float32)

        def solve():
            out = ref.solve(p, iters, ba, "tf32")
            return out["costs"], [], out["C"], 0
    else:
        eng = IncrementalSfM(ctx.pipeline, np.eye(3), frontend="precomputed", device=ctx.device)

        def solve():
            eng.load_checkpoint(io.BytesIO(blob))
            info = eng.finalize_global(iterations=iters)
            return (np.asarray(info["costs"], np.float64), list(info["cg_iterations"]), None,
                    int(info["slots"]))

        phases["load"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        for _ in range(int(tf["warm_solves"])):
            solve()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        phases["warm solves"] = time.perf_counter() - t_phase
    undo = [tr.wrap(global_ba, "build_global_problem")] if tr.on and not ctx.control else []
    runs, cg, C, slots, ends = [], [], None, 0, []
    window_start = time.perf_counter()
    ctx.window_started(window_start)
    deadline = window_start + ctx.seconds
    while time.perf_counter() < deadline:
        costs, its, C, slots = solve()
        ends.append(time.perf_counter())
        runs.append(costs)
        cg.append(sum(its))
    window = time.perf_counter() - window_start
    each = np.diff([window_start] + ends)
    out = {"attempted": len(runs), "failed": int(sum(not np.all(np.isfinite(c)) for c in runs)),
           "e2e": {"global_solve_s": window / max(len(runs), 1)}}
    if tr.on and not ctx.control:
        from benchmark import trace as tracing

        tr.context["cg_per_solve"] = cg
        torch.cuda.synchronize()
        with tracing.profile() as prof:
            t0 = time.perf_counter()
            with tr.span("finalize_global"):
                solve()
            torch.cuda.synchronize()
            profiled = time.perf_counter() - t0
        tr.device = tracing.read_profile(prof, profiled)
        out["busy_s"] = tr.device["union_s"]
        tr.context["profiled_steps"] = 1
    for u in undo:
        u()
    out["memory_peak_bytes"] = ctx.memory_peak()
    if not ctx.control:
        C, _ = eng.poses()
        del eng
    problem = ref.assemble(data)
    V = len(problem["C"])
    tr.context.update(slots=slots, n_cams=V, n_obs=len(problem["cam"]),
                      cam_rows=-(-int(np.bincount(problem["cam"], minlength=V).max()) // 8) * 8)
    # the reference: the plain float64 solve of the same arrays
    truth = ref.solve(ref.to_problem(problem, ctx.device, torch.float64), iters, ba, "f64")
    rc = truth["costs"]
    gaps = [np.abs(c - rc) / rc for c in runs]
    out["numbers"] = {
        "cost0_gap": float(max(g[0] for g in gaps)) if gaps else np.inf,
        "cost_gap": float(max(g.max() for g in gaps)) if gaps else np.inf,
    }
    # the problem fixes no gauge: centres compare after a similarity
    out["info"] = {"pose_gap": float(geometry.aligned_errors(C, truth["C"]).max()),
                   "solves": len(runs), "reference_costs": rc.tolist(),
                   "program_costs": runs[-1].tolist() if runs else None,
                   "cg_per_solve": cg[:3], "setup_phases_s": phases,
                   "solve_s_quartiles": np.percentile(each, [25, 50, 75]).tolist()
                   if len(each) else None}
    return out
