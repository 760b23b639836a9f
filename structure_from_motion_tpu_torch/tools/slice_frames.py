"""Wall time a frame of the single-sequence engine at the CLI's default
reconstruct configuration, on rendered 960x1280 frames, and of the
500-camera global solve.

    python3 -m structure_from_motion_tpu_torch.tools.slice_frames [--frames 16] [--repeat 1]
        [--stages] [--profile] [--global-solve N] [--sites] [--batch B]

Each repeat builds a fresh ``IncrementalSfM`` (seed 0) and times every
frame between two ``torch.cuda.synchronize()`` calls, with the host
synchronisations torch reports a frame (``torch.cuda.set_sync_debug_mode``)
and, where the package has them, the loop graphs' replays and stop-mask
reads a frame (``utils/control.stats``), each frame's CUDA graph replays
of its detect + match stretch and the grouped host copies it waited for
(an event wait, which torch's debug mode does not report); prints one
JSON line a repeat with the median of frames 2 onward (and of frames 2 to
the window, and of the slide frames past it). ``--profile`` runs one more
frame under
``torch.profiler``: kernels launched, device time, the busy share (the
union of the device's activity over the frame's wall time), and the
kernels and CUDA graphs the host launched. ``--sites`` prints the host
synchronisations of frame 0, the bootstrap, a steady frame and (with more
frames than the window) the last, a slide frame that evicts, by call site
(:func:`sync_site`), every site any frame reported listed in each (0 in a
frame that replays a CUDA graph: its switches and loops read nothing),
and the steady frame again with every stage eager (:func:`eager_frames`);
``--batch B`` runs the same frames again through
``BatchedIncrementalSfM`` with B lanes (every lane the same frames), with
its synchronisations a frame. ``--stages``
runs the frames again, every stage eager (a steady frame's graph replay
runs none on the host), with the engine's stages and the PnP and
triangulation steps each timed between two synchronisations (the medians
of frames 2 onward; the synchronisations slow the frame). The JSON line
also gives what the frame graphs cost: captures, capture and
instantiation seconds, nodes, pool bytes and bytes copied a replay. ``--global-solve
N`` loads ``artifacts/longrun500_pre_globalba.ckpt.npz`` and times
``finalize_global(20)`` N times after one warm-up solve.

To compare two versions on one card, unpack the other version's package
under ``build/`` (git ignores it), copy this file over its copy, and run
both from one command, in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ARTIFACT = Path(__file__).resolve().parents[2] / "artifacts" / "longrun500_pre_globalba.ckpt.npz"


def cli_default_config():
    """``python -m structure_from_motion_tpu_torch reconstruct``'s default
    configuration (2048 keypoints, 2x first octave, 5 octaves, window 16 in
    slide mode)."""
    from structure_from_motion_tpu_torch.__main__ import _build_config

    parser_defaults = argparse.Namespace(
        config=None, detector="dog", no_upsample=False, max_kp=2048, ratio=0.75,
        no_gate=False, max_views=16, window_mode="slide", ba_shards=1, dist=None,
        keyframe_min_flow=0.0, max_points=16384, max_observations=65536)
    return _build_config(parser_defaults)


def _loop_counts() -> tuple:
    """(loop chunk replays, stop-mask reads, frame graph replays, grouped
    host copies waited for) so far; 0 for what a version does not have. The
    device's counts of the graph replays no fetch brought yet are read
    first (one host read, outside the timed frame)."""
    from structure_from_motion_tpu_torch import device
    from structure_from_motion_tpu_torch.utils import control

    if hasattr(control, "settle"):
        control.settle()
    stats = getattr(control, "stats", None)
    copies = getattr(device, "HostCopy", None)
    return (getattr(stats, "replays", 0), getattr(stats, "reads", 0),
            getattr(stats, "call_replays", 0), getattr(copies, "waits", 0))


_PACKAGE = Path(__file__).resolve().parents[1]
# what torch says of a synchronising call (and not of its debug mode itself)
SYNC_MESSAGE = "called a synchronizing"


def sync_site(frame) -> str:
    """The call site of a host synchronisation whose warning is shown from
    ``frame`` (a frame of the ``warnings`` machinery): the innermost frame
    of the port's package outside ``tools/``, as
    ``"models/incremental.py:865 _finish_frame"``; when the synchronising
    call came from code outside the package (torch's ``cond``, a loaded
    program's generated code), its innermost frame follows after ``" < "``."""
    outer, f = None, frame
    while f is not None:
        path = Path(f.f_code.co_filename)
        if outer is None and path.name != "warnings.py":
            outer = f
        if path.is_relative_to(_PACKAGE) and not path.is_relative_to(_PACKAGE / "tools"):
            site = f"{path.relative_to(_PACKAGE).as_posix()}:{f.f_lineno} {f.f_code.co_name}"
            if outer is not f:
                site += f" < {Path(outer.f_code.co_filename).name}:{outer.f_lineno}"
            return site
        f = f.f_back
    if outer is None:
        return "outside the package"
    return f"outside the package < {Path(outer.f_code.co_filename).name}:{outer.f_lineno}"


@contextlib.contextmanager
def host_syncs(sites: collections.Counter | None = None):
    """Count in ``sites`` (a new ``Counter`` if None; yielded) every host
    synchronisation torch reports in the block
    (``torch.cuda.set_sync_debug_mode("warn")``), by :func:`sync_site`.
    An operator called through its ``OpOverload`` (a loaded program's boxed
    node) raises no Python warning: torch logs its report to the process's
    standard error instead, which is read here too, each line counted under
    ``"logged: <torch function>"`` (no Python frame to name)."""
    sites = collections.Counter() if sites is None else sites

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE in str(message):
            sites[sync_site(sys._getframe(1))] += 1

    mode = torch.cuda.get_sync_debug_mode()
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as log, warnings.catch_warnings():
        os.dup2(log.fileno(), 2)
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            log.seek(0)
            text = log.read().decode(errors="replace")
            for line in text.splitlines():
                if SYNC_MESSAGE in line:
                    fn = re.search(r"\(function (\w+)\)", line)
                    sites[f"logged: {fn.group(1) if fn else line[-60:]}"] += 1
                else:
                    print(line, file=sys.stderr)


def _timed(fn) -> tuple:
    """(result, wall s, host synchronisations by site) of ``fn()``,
    synchronised."""
    with host_syncs() as sites:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, sites


def _busy(prof, wall_s: float) -> dict:
    """Kernels, device time and busy share of one profiled frame."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:  # the union of the device's activity, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(device_events=len(spans), busy_ms=round(busy / 1e3, 3),
                busy_share=round(busy / 1e6 / wall_s, 4))


class _StageTimer:
    """Wraps module functions so that each call is timed between two
    synchronisations; nested stages count inside their parent."""

    SITES = (("models.incremental", "_front_stage"), ("models.incremental", "_match_stage"),
             ("models.incremental", "_bootstrap_stage"),
             ("models.incremental", "_localize_stage"), ("models.incremental", "_ba_stage"),
             ("models.incremental", "_triangulate_new_flat"), ("models.incremental", "_admit_new"),
             ("models.incremental", "detect_and_describe"), ("ops.pnp", "linear_pnp_ransac"),
             ("ops.pnp", "_lm_steps"), ("ops.triangulation", "refine_triangulate"))

    def __init__(self):
        import importlib

        self.frame: collections.Counter = collections.Counter()
        self.saved = []
        for mod, name in self.SITES:
            m = importlib.import_module(f"structure_from_motion_tpu_torch.{mod}")
            if hasattr(m, name):
                self.saved.append((m, name, getattr(m, name)))
                setattr(m, name, self._wrap(name, getattr(m, name)))

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            # a stage inside a CUDA graph's warm-up or capture runs untimed
            if torch.cuda.is_current_stream_capturing() or torch.cuda.get_sync_debug_mode() == 2:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.frame[name] += time.perf_counter() - t0
            return out
        return timed

    def close(self):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def _site_frames(n: int, window: int) -> dict:
    """The frames whose synchronisations :func:`run` prints by site: frame
    0, the bootstrap, a steady frame and, past the window, a slide frame
    that evicts."""
    steady = min(8, n - 1)
    picks = {"frame 0": 0, "frame 1 (bootstrap)": 1, f"frame {steady} (steady)": steady}
    if n > window:
        picks[f"frame {n - 1} (slide, evicts)"] = n - 1
    return {k: v for k, v in picks.items() if v < n}


def _graph_numbers() -> dict:
    """What ``control.graphed`` captured so far (0 for what a version does
    not have): captures and replays, the captures' seconds (the pass in
    the device form included), the graphs' nodes, the reserved memory the
    captures added, the bytes a replay copied in and out."""
    from structure_from_motion_tpu_torch.utils import control

    st = control.stats
    g = {k: getattr(st, k, 0) for k in ("call_captures", "call_replays", "call_nodes",
                                        "capture_s", "instantiate_s", "pool_bytes",
                                        "copy_bytes")}
    g["copied_bytes_a_replay"] = g.pop("copy_bytes") // max(g["call_replays"], 1)
    return g


@contextlib.contextmanager
def eager_frames():
    """Every ``control.graphed`` call of the engine made a plain call in the
    block: each stage runs op by op between its host reads (the frames the
    graphs replace, for ``--stages`` and the eager column of ``--sites``)."""
    from structure_from_motion_tpu_torch.models import incremental

    graphed = incremental.graphed
    incremental.graphed = lambda fn, *operands, calls=None: fn(*operands)
    try:
        yield
    finally:
        incremental.graphed = graphed


def with_zeros(by_site: list, picks: dict) -> dict:
    """``{label: {site: synchronisations}}`` of the frames ``picks`` names
    (``{label: index into by_site}``), every site any frame of ``by_site``
    reported listed in each (0 where a frame made none: a site inside a
    CUDA graph reads nothing)."""
    names = sorted({k for found in by_site for k in found})
    return {label: {k: by_site[i].get(k, 0) for k in names} for label, i in picks.items()}


def _launches(prof) -> dict:
    """Kernel and graph launches the host made in one profiled frame."""
    names = collections.Counter(e.name for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CPU)
    kernels = sum(v for k, v in names.items() if k in ("cudaLaunchKernel", "cuLaunchKernel",
                                                         "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    return dict(host_kernel_launches=kernels, graph_launches=names.get("cudaGraphLaunch", 0))


def run(frames: int, repeat: int, stages: bool = False, profile: bool = False,
        global_solve: int = 0, sites: bool = False, batch: int = 0) -> list:
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    imgs, K, _, _ = synthetic_scene_sequence(n_frames=frames + 1, size=(960, 1280), seed=3,
                                             loops=0.07 * (frames + 1))
    cfg = cli_default_config()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = []
    for _ in range(repeat):
        eng = IncrementalSfM(cfg, K, frontend="native", seed=0, device="cuda")
        times, syncs, by_site, counts = [], [], [], []
        for im in imgs[:frames]:
            r0 = _loop_counts()
            _, wall, frame_sites = _timed(lambda: eng.process_image(im))
            counts.append([b - a for a, b in zip(r0, _loop_counts())])
            times.append(wall)
            syncs.append(sum(frame_sites.values()))
            by_site.append(frame_sites)
        replays, reads, front, waits = (list(c) for c in zip(*counts))
        window = cfg.window_size
        res = dict(median_s=float(np.median(times[2:])),
                   median_window_s=float(np.median(times[2:window])),
                   median_slide_s=(float(np.median(times[window:])) if frames > window
                                   else None),
                   times_s=[round(t, 4) for t in times], syncs=syncs,
                   median_syncs=float(np.median(syncs[2:])), replays=replays, reads=reads,
                   frame_graph_replays=front, host_copy_waits=waits, graphs=_graph_numbers(),
                   card=card)
        if sites:
            picks = _site_frames(frames, cfg.window_size)
            steady = min(8, frames - 1)
            eager = IncrementalSfM(cfg, K, frontend="native", seed=0, device="cuda")
            with eager_frames():  # the same frames with every stage eager
                for im in imgs[:steady + 1]:
                    _, _, eager_sites = _timed(lambda: eager.process_image(im))
            by_site.append(eager_sites)
            picks[f"frame {steady} (steady, every stage eager)"] = len(by_site) - 1
            res["sites"] = with_zeros(by_site, picks)
        if profile:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                _, wall, _ = _timed(lambda: eng.process_image(imgs[frames]))
            res["profiled_frame"] = dict(wall_s=round(wall, 4), **_busy(prof, wall),
                                         **_launches(prof))
        out.append(res)
        print(json.dumps(res), flush=True)
    if batch:
        from structure_from_motion_tpu_torch.models.batched import BatchedIncrementalSfM

        eng = BatchedIncrementalSfM(cfg, K, batch=batch, seed=0, device="cuda")
        times, syncs, by_site = [], [], []
        for im in imgs[:frames]:
            lanes = torch.as_tensor(np.stack([im] * batch))
            _, wall, frame_sites = _timed(lambda: eng.process_images(lanes))
            times.append(wall)
            syncs.append(sum(frame_sites.values()))
            by_site.append(frame_sites)
        res = dict(batch=batch, median_s=float(np.median(times[2:])),
                   times_s=[round(t, 4) for t in times], syncs=syncs,
                   median_syncs=float(np.median(syncs[2:])), card=card)
        if sites:
            res["sites"] = with_zeros(by_site, _site_frames(frames, cfg.window_size))
        out.append(res)
        print(json.dumps(res), flush=True)
    if stages:
        timer = _StageTimer()
        # a graph replay runs no stage on the host: these are eager frames'
        try:
            with eager_frames():
                eng = IncrementalSfM(cfg, K, frontend="native", seed=0, device="cuda")
                per_frame = []
                for im in imgs[:frames]:
                    timer.frame.clear()
                    _, wall, _ = _timed(lambda: eng.process_image(im))
                    per_frame.append(dict(timer.frame, frame=wall))
        finally:
            timer.close()
        names = sorted({k for f in per_frame for k in f})
        med = {k: round(1e3 * float(np.median([f.get(k, 0.0) for f in per_frame[2:]])), 2)
               for k in names}
        print(json.dumps(dict(stages_ms_median=med, card=card)), flush=True)
    if global_solve:
        eng = IncrementalSfM(_long_sequence_config(), np.eye(3), frontend="precomputed",
                             device="cuda")
        walls, syncs = [], []
        for i in range(global_solve + 1):
            eng.load_checkpoint(str(ARTIFACT))
            torch.cuda.synchronize()
            r0 = _loop_counts()
            info, wall, solve_sites = _timed(lambda: eng.finalize_global(iterations=20))
            if i:  # the first solve warms up
                walls.append(wall)
                syncs.append(sum(solve_sites.values()))
        res = dict(global_wall_s=[round(w, 4) for w in walls],
                   global_median_s=float(np.median(walls)), syncs=syncs,
                   cg=list(info["cg_iterations"]), final_cost=float(info["costs"][-1]),
                   replays_reads_last=[a - b for a, b in zip(_loop_counts(), r0)], card=card)
        print(json.dumps(res), flush=True)
        out.append(res)
    return out


def _long_sequence_config():
    """``examples/run_long_sequence.py``'s engine configuration, which the
    500-camera checkpoint was written with (``chip_smoke.py``'s)."""
    from structure_from_motion_tpu_torch.config import (
        BAConfig,
        CapacityConfig,
        FrontendConfig,
        LMConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )

    return PipelineConfig(
        frontend=FrontendConfig(max_keypoints=1024, upsample_first_octave=False),
        matcher=MatcherConfig(ratio=0.9),
        fundamental_ransac=RansacConfig(inlier_threshold=2.0, iteration=256),
        pnp_ransac=RansacConfig(inlier_threshold=8.0, sample_num=6, iteration=512),
        pnp_lm=LMConfig(damping=5.0, iterations=100),
        triangulation_lm=LMConfig(damping=5.0, iterations=50),
        ba=BAConfig(iterations=3, damping=5.0, huber_delta=0.01),
        capacity=CapacityConfig(max_views=8, max_keypoints=1024, max_points=8192,
                                max_observations=32768),
        window_size=8,
        window_mode="slide",
    )


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--stages", action="store_true", help="time the stages, synchronised")
    p.add_argument("--profile", action="store_true", help="profile one more frame")
    p.add_argument("--global-solve", type=int, default=0, metavar="N",
                   help="time finalize_global(20) on the 500-camera checkpoint N times")
    p.add_argument("--sites", action="store_true",
                   help="print the host synchronisations of frames 0, 1, a steady frame and a "
                        "slide frame by call site")
    p.add_argument("--batch", type=int, default=0, metavar="B",
                   help="also run the batched engine with B lanes of the same frames")
    a = p.parse_args()
    run(a.frames, a.repeat, a.stages, a.profile, a.global_solve, a.sites, a.batch)
