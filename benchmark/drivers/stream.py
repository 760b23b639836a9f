"""Closed-loop frame traffic: one sequence fed to ``IncrementalSfM.process_image``
frame after frame, or ``lanes`` sequences fed to
``BatchedIncrementalSfM.process_images`` step after step.

Traffic parameters (``traffic/<name>.json``): ``ring_frames`` frames of the
rendered path over ``loops`` turns (a ring that repeats seamlessly when the
path is periodic over it); ``lanes`` (0: the single engine) and
``lane_offset`` (lane b starts ``b * lane_offset`` frames after the first);
``texture_seed`` (the scene's textures), ``start`` (the ring's first frame)
and ``engine_seed`` (the engine's draws; lane b's ``engine_seed + b``), each
the run's seed where the file gives null; ``profiled_steps``, the frames
(steps) of the traced run's profiled window.

Set-up renders the ring on the card, copies it to host
memory (each frame's upload is in the timed path), and runs the engine
until its window has slid once, so every frame of the window evicts a view,
as a user's long stream does. The window then feeds frames for
``seconds``; each frame is timed from the call until it returns with its
grouped fetch waited for (the pose and statistics on the host).

What is judged, once the window has closed:

* every frame's pose, archived and live, against the exact path, by the
  similarity-aligned error as a share of the path's span
  (``reference/geometry.py``); with lanes, the worst lane's (``ate_pct``);
* the per-frame bundle adjustments of the judged frames: every 16th
  frame of the window from its first (every 4th step with lanes), and its
  last. Before each the engine's state is held (an asynchronous copy into
  pinned host memory of a pool made in set-up; the last frame's by
  reference), with the ``ba_costs`` the timed call returned. After the profiled steps each judged
  frame runs again from its held state, eagerly: the engine's eviction,
  then ``incremental._frame_body`` at the same slot with the frame's draws
  and image, while a wrapper of ``incremental._ba_stage`` records what
  every lane's BA receives. The plain float64 LM of
  ``reference/global_ba.py`` solves each lane's entry
  (``reference/frame_ba.py``), once the program's state is freed; the
  timed costs are compared with its costs (``ba_cost0_gap``: the first,
  ``ba_cost_gap``: the worst of them, relative, the worst lane-frame).
  ``info`` adds ``rerun_cost_gap`` (the rerun's own costs against the timed
  ones: whether the eager rerun followed the graph), the judged count and
  the judge's seconds.

The control (``--control 1``): the reference in TF32 in the per-frame
BA's place, its costs compared as the timed ones are. The program with TF32
products on is no control here: it fails no number (TF32 reaches only the
Schur products, not kernel B4's residuals; ``PERF.md`` §2).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from benchmark.reference import frame_ba, geometry, scene
from benchmark.reference import global_ba as ref


def _or_seed(ctx, key: str) -> int:
    """The traffic's ``key``, or the run's seed where it is null or absent."""
    value = ctx.traffic.get(key)
    return ctx.seed if value is None else int(value)


def _engine(ctx, K):
    from structure_from_motion_tpu_torch.models.batched import BatchedIncrementalSfM
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    lanes, seed = ctx.traffic.get("lanes", 0), _or_seed(ctx, "engine_seed")
    if lanes:
        return BatchedIncrementalSfM(ctx.pipeline, K, batch=lanes,
                                     seed=[seed + b for b in range(lanes)], device=ctx.device)
    return IncrementalSfM(ctx.pipeline, K, frontend="native", seed=seed, device=ctx.device)


class _HostStates:
    """Pinned host copies of engine states, made without a host wait: a pool
    of ``n`` made in set-up (``n`` an estimate of the judged frames), one
    more allocated where the pool runs out (counted in ``misses``)."""

    def __init__(self, like, n: int):
        self.pin = like.points.is_cuda
        self.free = [self._empty(like) for _ in range(n)]
        self.misses = 0

    def _empty(self, like):
        return type(like)(*(torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pin)
                            for t in like))

    def copy(self, state):
        if not self.free:
            self.misses += 1
            self.free.append(self._empty(state))
        held = self.free.pop()
        for h, t in zip(held, state):
            h.copy_(t, non_blocking=True)
        return held


def run(ctx) -> dict:
    from structure_from_motion_tpu_torch import device as port_device
    from structure_from_motion_tpu_torch.models import incremental
    from structure_from_motion_tpu_torch.utils import control, profiling

    tr = ctx.trace
    phases = {"imports": time.perf_counter() - ctx.start}
    t_phase = time.perf_counter()
    size = tuple(ctx.config["frame_size"])
    ring, loops = ctx.traffic["ring_frames"], ctx.traffic["loops"]
    lanes = ctx.traffic.get("lanes", 0)
    offset = ctx.traffic.get("lane_offset", 0)
    every = 4 if lanes else 16  # the judged frames' stride
    start = _or_seed(ctx, "start") % ring
    texture = _or_seed(ctx, "texture_seed")
    frames = scene.render(ring, size, texture, loops, ctx.device).cpu().numpy()
    if ctx.device.type == "cuda":  # the peak is the engine's, not the renderer's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    K, C_true, _ = scene.path_poses(ring, size, loops)
    phases["render"] = time.perf_counter() - t_phase
    eng = _engine(ctx, K)

    def images(i):
        if lanes:
            return np.stack([frames[(start + b * offset + i) % ring] for b in range(lanes)])
        return frames[(start + i) % ring]

    def feed(i):
        if lanes:
            return eng.process_images(images(i))
        return eng.process_image(images(i))

    # set-up: until the window has slid once (every later frame evicts)
    n, steady = 0, []
    for n in range(ctx.pipeline.window_size + 1):
        t_phase = time.perf_counter()
        feed(n)
        took = time.perf_counter() - t_phase
        name = ("frame 0", "frame 1", "frame 2")[n] if n < 3 else "frames 3+"
        phases[name] = phases.get(name, 0.0) + took
        if n >= 3:
            steady.append(took)
    n += 1
    t_phase = time.perf_counter()
    # the judged frames' held states: a frame of the window takes at least
    # as long as the fastest steady frame of the set-up
    frame_s = min(steady) if steady else ctx.seconds
    pool = _HostStates(eng.state, int(math.ceil(ctx.seconds / frame_s / every)) + 1)
    phases["state pool"] = time.perf_counter() - t_phase
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    tr.context["capture_s"] = control.stats.capture_s + control.stats.instantiate_s
    undo = [tr.wrap_graphed(incremental)] if tr.on else []
    if tr.on:  # the port's spans: read by frame_evict_ms
        profiling.reset()
        profiling.enable(True)
    waits0 = port_device.HostCopy.waits
    lat, bad, held, first = [], 0, [], n
    window_start = time.perf_counter()
    ctx.window_started(window_start)
    with tr.host_syncs() if tr.on else contextlib.nullcontext():
        deadline = window_start + ctx.seconds
        while time.perf_counter() < deadline:
            state_in = eng.state  # the last frame's is judged by reference
            judged = (n - first) % every == 0
            if judged:
                held.append([n, pool.copy(state_in), None])
            t0 = time.perf_counter()
            info = feed(n)
            lat.append(time.perf_counter() - t0)
            bad += not np.all(np.isfinite(np.asarray(info["reprojection_px"], np.float64)))
            costs = np.asarray(info["ba_costs"], np.float64).reshape(max(lanes, 1), -1)
            if judged:
                held[-1][2] = costs
            n += 1
    window = time.perf_counter() - window_start
    if lat and held[-1][0] != n - 1:
        held.append([n - 1, state_in, costs])
    del state_in
    out = {"attempted": len(lat), "failed": int(bad),
           "e2e": {"frames_per_s": len(lat) * max(lanes, 1) / window,
                   "frame_p95_ms": 1e3 * _p95(lat)}}
    if tr.on:
        tr.context["program_spans"] = profiling.records()
        tr.counts["host_copy_waits"] = port_device.HostCopy.waits - waits0
        tr.counts["frames_synced"] = len(lat)
        tr.take_graph_times()
        steps = ctx.traffic["profiled_steps"]
        from benchmark import trace as tracing

        torch.cuda.synchronize()
        with tracing.profile() as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                with tr.span("process_images" if lanes else "process_image"):
                    feed(n)
                n += 1
            torch.cuda.synchronize()
            profiled = time.perf_counter() - t0
        profiling.enable(False)
        tr.device = tracing.read_profile(prof, profiled)
        out["busy_s"] = tr.device["busy_s"]  # a replay's extent: CUPTI misses its IF bodies
        tr.context["profiled_steps"] = steps
        for u in undo:
            u()
    cap = ctx.pipeline.capacity
    valid = eng.state.kp_valid.sum(-1).double().mean()
    tr.context.update(frontend=dataclasses.asdict(ctx.pipeline.frontend), frame_size=size,
                      lanes=max(lanes, 1), n_views=cap.max_views, n_keypoints=cap.max_keypoints,
                      valid_queries=float(valid))
    out["memory_peak_bytes"] = ctx.memory_peak()
    C, _ = eng.poses()
    out["numbers"], out["info"] = judge(C, C_true, ring, start, offset, lanes)
    t_judge = time.perf_counter()
    eng.state = None  # the reruns start from the held states
    entries, rerun = rerun_frames(ctx, eng, held, images)
    timed, misses = [h[2] for h in held], pool.misses
    del eng, held, pool
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, frames_info = judge_frames(ctx, entries, timed, rerun)
    out["numbers"].update(numbers)
    out["info"].update(frames_info, judge_s=time.perf_counter() - t_judge,
                       frame_ms_quartiles=_quartiles(1e3 * np.asarray(lat)),
                       state_pool_misses=misses, setup_phases_s=phases)
    if tr.on:
        out["info"]["evict_ms_quartiles"] = _quartiles(
            [1e-6 * (s.end_ns - s.start_ns) for s in tr.context["program_spans"]
             if s.name == "frame.evict"])
    return out


def rerun_frames(ctx, eng, held: list, images) -> tuple:
    """Each held frame again, eagerly, from its held state: the engine's
    eviction, then ``incremental._frame_body`` at the window's last slot
    with the frame's draws and image, the front stage through the engine's
    graphs. Returns (entries, costs): a list a frame of what each lane's BA
    received (``frame_ba.FIELDS``, host arrays with the lane axis), and the
    rerun's own BA costs (lanes, iterations). Planted faults stay in place."""
    from structure_from_motion_tpu_torch.device import to_device
    from structure_from_motion_tpu_torch.models import incremental, tracks

    entries, costs = [], []
    stage = incremental._ba_stage

    def recording(st, config):
        entries.append({k: getattr(st, k).detach().cpu().numpy() for k in frame_ba.FIELDS})
        res = stage(st, config)
        costs.append(res[1].detach().double().cpu().numpy())
        return res

    seeds = getattr(eng, "seeds", None) or [eng.seed]
    slot = min(ctx.pipeline.capacity.max_views, ctx.pipeline.window_size) - 1
    incremental._ba_stage = recording
    try:
        for n, state, _ in held:
            st = type(state)(*(t.to(ctx.device) for t in state))
            st, _ = tracks.evict_oldest_view(st)
            if st.num_points.dim() == 0:  # a single engine's state: a stack of one lane
                st = tracks.lanes_of(st)
            img = to_device(torch.as_tensor(images(n)), ctx.device)
            draws = incremental.LazyDraws(seeds, n, ctx.device)
            incremental._frame_body(st, slot, draws, img, stage=2, config=ctx.pipeline,
                                    graphs=eng._graphs)
    finally:
        incremental._ba_stage = stage
    return entries, costs


def _gap(a, b) -> np.ndarray:
    """|a - b| / |b|, elementwise (0 where a == b, inf where only b is 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(a == b, 0.0, np.abs(a - b) / np.abs(b))


def judge_frames(ctx, entries: list, timed: list, rerun: list) -> tuple:
    """(numbers, information) of the judged frames: each lane's entry solved
    by the plain float64 LM (``reference/global_ba.py``) for as many
    iterations as the per-frame BA runs, its costs against the timed ones."""
    ba = dataclasses.asdict(ctx.pipeline.ba)
    iters = int(ba["iterations"])
    g0, g, gr, drop, left_out, sizes = [], [], [], [], 0, []
    for entry, costs, again in zip(entries, timed, rerun):
        for b in range(costs.shape[0]):
            arrays = frame_ba.assemble({k: v[b] for k, v in entry.items()})
            left_out += arrays["left_out"]
            sizes.append(len(arrays["cam"]))
            gr.append(_gap(again[b], costs[b]).max())
            if not sizes[-1]:  # a steady frame's BA with nothing to adjust: the map is lost
                g0.append(math.inf)
                g.append(math.inf)
                continue
            truth = ref.solve(ref.to_problem(arrays, ctx.device, torch.float64), iters, ba,
                              "f64")["costs"]
            drop.append(1.0 - truth[-1] / truth[0])
            mine = costs[b]
            if ctx.control:  # the reference in TF32 in the per-frame BA's place
                mine = ref.solve(ref.to_problem(arrays, ctx.device, torch.float32), iters, ba,
                                 "tf32")["costs"]
            g0.append(_gap(mine[0], truth[0]))
            g.append(_gap(mine, truth).max())
    worst = lambda x: float(np.max(x)) if x else math.inf  # noqa: E731
    info = {"judged_lane_frames": len(g), "rerun_cost_gap": worst(gr),
            "ba_obs_left_out": int(left_out), "ba_obs_min_max": [min(sizes), max(sizes)]
            if sizes else None, "empty_lane_frames": sizes.count(0),
            "reference_cost_drop": _quartiles(drop)}
    return {"ba_cost0_gap": worst(g0), "ba_cost_gap": worst(g)}, info


def judge(C, C_true, ring: int, start: int, offset: int, lanes: int) -> tuple:
    """(numbers, information) of every lane's poses, archived and live,
    against the exact path: the similarity-aligned error as a share of the
    path's span, in float64."""
    C = np.asarray(C, np.float64).reshape((max(lanes, 1), -1, 3))
    ate, lost, worst_at = [], [], []
    for b in range(C.shape[0]):
        truth = C_true[(start + b * offset + np.arange(C.shape[1])) % ring]
        err = geometry.aligned_errors(C[b], truth)
        ate.append(100.0 * math.sqrt(float(np.mean(err ** 2))))
        lost.append(int((err > 0.01).sum()))
        worst_at.append(int(np.argmax(err)))
    return {"ate_pct": max(ate)}, {"frames": int(C.shape[1]), "ate_pct_by_lane": ate,
                                   "frames_off_by_1pct": lost, "worst_frame": worst_at}


def _quartiles(values) -> list | None:
    """[min, first quartile, median, third quartile, max] of the values."""
    if not len(values):
        return None
    return np.percentile(np.asarray(values, np.float64), [0, 25, 50, 75, 100]).tolist()


def _p95(values) -> float:
    """The 95th percentile of every value (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95)) if values else math.nan

