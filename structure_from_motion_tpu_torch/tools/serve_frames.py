"""Live against served frames: where a served frame's time goes.

    python3 -m structure_from_motion_tpu_torch.tools.serve_frames [--frames 8] [--device cuda]

Exports a fresh native engine's ``frame_step_native`` alone (the CLI's
default configuration on rendered 960x1280 frames on the card; a small
configuration at 240x320 with ``--device cpu``), loads it, and runs the same
frames through a live and a served engine: the wall time of every frame
between two synchronisations, the host synchronisations a frame
(``torch.cuda.set_sync_debug_mode``; on the card only), and for the last
frame of each the operators that took the most host time, and on the card
the kernels that took the most device time, under ``torch.profiler``
(``--python-profile``: one more frame, and the export's save, under
``cProfile``). Also each frame's loop-mask reads, CUDA graph captures and
replays (``utils/control.stats``), the export's trace and save seconds,
the program's and artifact's bytes and the load seconds. Prints one JSON
line a run, then the profiles.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time
import warnings

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


def _python_profile(engine, im, device: str) -> str:
    """The Python functions that took the most time in one more frame."""
    import cProfile

    prof = cProfile.Profile()
    prof.enable()
    engine.process_image(im)
    if device == "cuda":
        torch.cuda.synchronize()
    prof.disable()
    return _top(prof, "tottime", 25)


def _profiled(fn, sink: list):
    """``fn`` run under ``cProfile``; each call's profile appended to ``sink``."""
    import cProfile

    def run(*args, **kwargs):
        prof = cProfile.Profile()
        prof.enable()
        try:
            return fn(*args, **kwargs)
        finally:
            prof.disable()
            sink.append(prof)
    return run


def _frames(engine, imgs, device: str, profile_last: bool):
    """(wall s a frame, host synchronisations a frame, loop stats a frame,
    profile of the last)."""
    from structure_from_motion_tpu_torch.utils import control

    times, syncs, loops, table = [], [], [], ""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    for i, im in enumerate(imgs):
        sync()
        last = profile_last and i == len(imgs) - 1
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts) if last else None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            control.reset_stats()
            t0 = time.perf_counter()
            if prof is not None:
                prof.__enter__()
            engine.process_image(im)
            sync()
            if prof is not None:
                prof.__exit__(None, None, None)
            times.append(time.perf_counter() - t0)
            st = control.stats
            loops.append(dict(reads=st.reads, replays=st.replays, captures=st.captures,
                              pool_bytes=st.pool_bytes))
            if device == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        if prof is not None:
            avg = prof.key_averages()
            table = avg.table(sort_by="self_cpu_time_total", row_limit=12)
            if device == "cuda":
                dev_us = sum(e.self_device_time_total for e in avg)
                table += (f"\ndevice time {dev_us / 1e3:.3f} ms in all; by device time:\n"
                          + avg.table(sort_by="self_cuda_time_total", row_limit=12))
    return times, syncs, loops, table


def run(frames: int, device: str, python_profile: bool = False) -> dict:
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
        torch.export.save = _profiled(save, saves)
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
               load_s=load_s)
    tables = {}
    for name, engine in (("live", live), ("served", served)):
        times, syncs, loops, tables[name] = _frames(engine, imgs[:-1], device, profile_last=True)
        out[name] = dict(median_s=float(np.median(times[2:-1])), times_s=times, syncs=syncs,
                         loops=loops)
        if python_profile:
            tables[name] += "\n" + _python_profile(engine, imgs[-1], device)
    out["same_bits"] = all(torch.equal(a, b) for a, b in zip(live.state, served.state))
    out["same_reads"] = ([f["reads"] for f in out["live"]["loops"]]
                         == [f["reads"] for f in out["served"]["loops"]])
    print(json.dumps(out))
    for name, table in tables.items():
        print(f"{name}, last frame, by host time:\n{table}")
    for prof in saves:
        print("the export's save (profiled, so slower than save_s), by cumulative time:\n"
              + _top(prof, "cumulative", 30))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--python-profile", action="store_true",
                   help="also run one more frame of each, and the save, under cProfile")
    a = p.parse_args()
    run(a.frames, a.device, a.python_profile)
