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

What is judged: every frame's pose, archived and live, against the exact
path, by the similarity-aligned error as a share of the path's span
(``reference/geometry.py``); with lanes, the worst lane's. The control is
the program with TF32 products on; it does not fail this number, so the
cells of this driver wait in ``pending.json`` (``PERF.md``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from benchmark.reference import geometry, scene


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


def run(ctx) -> dict:
    from structure_from_motion_tpu_torch import device as port_device
    from structure_from_motion_tpu_torch.models import incremental
    from structure_from_motion_tpu_torch.utils import control

    tr = ctx.trace
    if ctx.control:  # the nearest precision below the configuration's float32
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    phases = {"imports": time.perf_counter() - ctx.start}
    t_phase = time.perf_counter()
    size = tuple(ctx.config["frame_size"])
    ring, loops = ctx.traffic["ring_frames"], ctx.traffic["loops"]
    lanes = ctx.traffic.get("lanes", 0)
    offset = ctx.traffic.get("lane_offset", 0)
    start = _or_seed(ctx, "start") % ring
    texture = _or_seed(ctx, "texture_seed")
    frames = scene.render(ring, size, texture, loops, ctx.device).cpu().numpy()
    if ctx.device.type == "cuda":  # the peak is the engine's, not the renderer's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    K, C_true, _ = scene.path_poses(ring, size, loops)
    phases["render"] = time.perf_counter() - t_phase
    eng = _engine(ctx, K)

    def feed(i):
        if lanes:
            return eng.process_images(np.stack([frames[(start + b * offset + i) % ring]
                                                for b in range(lanes)]))
        return eng.process_image(frames[(start + i) % ring])

    # set-up: until the window has slid once (every later frame evicts)
    n = 0
    for n in range(ctx.pipeline.window_size + 1):
        t_phase = time.perf_counter()
        feed(n)
        name = ("frame 0", "frame 1", "frame 2")[n] if n < 3 else "frames 3+"
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t_phase
    n += 1
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    tr.context["capture_s"] = control.stats.capture_s + control.stats.instantiate_s
    undo = [tr.wrap_graphed(incremental)] if tr.on else []
    waits0 = port_device.HostCopy.waits
    lat, bad = [], 0
    window_start = time.perf_counter()
    ctx.window_started(window_start)
    with tr.host_syncs() if tr.on else contextlib.nullcontext():
        deadline = window_start + ctx.seconds
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            info = feed(n)
            lat.append(time.perf_counter() - t0)
            bad += not np.all(np.isfinite(np.asarray(info["reprojection_px"], np.float64)))
            n += 1
    window = time.perf_counter() - window_start
    out = {"attempted": len(lat), "failed": int(bad),
           "e2e": {"frames_per_s": len(lat) * max(lanes, 1) / window,
                   "frame_p95_ms": 1e3 * _p95(lat)}}
    if tr.on:
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
    del eng
    out["numbers"], out["info"] = judge(C, C_true, ring, start, offset, lanes)
    out["info"].update(frame_ms_median=1e3 * float(np.median(lat)) if lat else None,
                       setup_phases_s=phases)
    return out


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


def _p95(values) -> float:
    """The 95th percentile of every value (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95)) if values else math.nan

