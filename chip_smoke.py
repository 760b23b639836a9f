#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing its numbers on its own line; any failure raises and
the script exits non-zero without printing the final result line:

1. environment: a CUDA card must be visible; prints its nvidia-smi name and
   power limit, the torch/CUDA versions and both TF32 switches;
2. build: compiles ``structure_from_motion_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernels: each of the Hopper kernels against its plain PyTorch
   version on the card, at the shapes its path gives it, with the
   tolerance stated beside it, the median CUDA-event time of both, the
   kernel's bound (the larger of its bytes over the card's memory rate and
   its operations over the card's peak rate, computed here from the shapes
   of this run) and, where one PyTorch call computes the same function,
   that call's time: B1-B4 at the per-frame slice's shapes (B1 and the
   fused B2, "B2f", at every shape a frame launches them at: the base blur
   and the five octaves from 1920x2560 down to 120x160, one entry a shape,
   B2f bit for bit, also on a stack full of ties and all-zero blocks and on
   two launches; the B2 kernel that writes the whole response map, and B1
   again, at every shape a 600x800 frame launches them at, 1200x1600 down
   to 75x100, 300x400 and below not multiples of 8; ``topk_block`` 4 (the
   map kernel and two reductions) against the CPU; the whole candidate
   stage at octave 0 before and after the fusion; B3 also on the
   x512 descriptors of rendered frames, with the matcher's decisions), then
   B4, B5 and B6 at the shape of the 500-camera global solve (the real
   stream of ``artifacts/longrun500_pre_globalba.ckpt.npz``) and B4 at the
   same O with V = 16; B3, B4 and B6 must give the same bits twice;
4. slice: 24 rendered 960x1280 frames through the port's
   ``IncrementalSfM`` at the CLI's default reconstruct configuration
   (window 16 in slide mode, so frames 16-23 evict and archive a view),
   then ``finalize_global`` over all 24 cameras (a dense Schur solve);
   every kernel's launch count (B1's and B2's by shape too: five fused B2
   launches a frame, none of the map kernel), the per-frame wall time, and the
   similarity-aligned ATE (before and after the global solve) and mean
   reprojection error against the exact rendered ground truth;
5. global: the 500-camera checkpoint loaded with the port's
   ``load_checkpoint`` and solved by ``finalize_global(iterations=20)``
   (tiered layout, PCG through B5/B6): problem size, CG iterations per LM
   step, costs, synchronised wall time, launches, and the final cost
   against the JAX package's f32 result for the same input;
6. CLI: the first 20 of the rendered frames written as 24-bit BMP files and
   reconstructed by ``python -m structure_from_motion_tpu_torch
   reconstruct`` (called in-process) at its default flags plus the three
   exports and ``--checkpoint-every 8``, through the stream prefetcher;
   then ``--resume`` on a directory holding 4 more frames. Checked: exit
   code 0, ATE and reprojection against the rendered truth, every export
   read back to the same poses, the resume starting at input 20, B1-B4
   launched. Then the median frame time with the prefetcher and with a
   plain loop (host wall time), ``selftest``, and 6 frames of 600x800
   with ``--config`` (``topk_block`` 0), the path that launches the B2 map
   kernel (8 does not divide 300x400 either), held to the same ATE and
   reprojection bounds.

Every phase's launch counts are set to 0 just before it and read just
after. The last two lines are a JSON object of the kernels' numbers and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

# 0.07 loops per frame, the motion of tests/test_synthetic_gt.py:77-79
RENDER = dict(n_frames=24, size=(960, 1280), seed=3, loops=1.68)
# a frame size whose deeper octaves (300x400 and below) 8 does not divide
RENDER_SMALL = dict(n_frames=6, size=(600, 800), seed=3, loops=0.42)
ATE_BOUND = 0.05  # of the trajectory span (tests/test_synthetic_gt.py:86-90)
REPROJ_BOUND_PX = 2.0
ARTIFACT = Path(__file__).resolve().parent / "artifacts" / "longrun500_pre_globalba.ckpt.npz"
# final cost of the JAX package's f32 solve of the artifact on the CPU
# (solve_global(iterations=20), BAConfig(huber_delta=0.01))
JAX_GLOBAL_COST = 0.5122
# CG iterations per LM step of that solve with the first port's kernels on an
# H100; B4's sums come in another order now, so each may move by up to 2
GLOBAL_CG_ITERATIONS = [6, 7, 10, 14, 19, 22, 31, 40, 57] + [64] * 11
# Published peaks of one NVIDIA H100 SXM at its full 700 W limit (NVIDIA's
# H100 data sheet, dense rates without sparsity): the yardsticks of every
# kernel's bound, whatever limit the card of this run is set to
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12  # CUDA cores
PEAK_TF32_FLOPS = 495e12  # tensor cores


def _median_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms between two CUDA events, warm L2.
    A wrapper call costs the host more than its kernels cost the card, so
    the card first spins for ~0.3 ms (no memory traffic) while the host
    enqueues the events and the call: the events then bracket the kernels
    back to back, not the host's enqueue."""
    import numpy as np

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(500_000)  # device cycles
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _umeyama_ate(est, gt) -> float:
    """RMS camera-centre error after the best similarity alignment."""
    import numpy as np

    mu_s, mu_d = est.mean(0), gt.mean(0)
    sc, dc = est - mu_s, gt - mu_d
    U, S, Vt = np.linalg.svd(dc.T @ sc / len(est))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((sc**2).sum() / len(est))
    aligned = (s * (R @ est.T)).T + (mu_d - s * R @ mu_s)
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))


def cli_default_config():
    """The configuration of ``python -m structure_from_motion_tpu reconstruct``
    with its default flags (``structure_from_motion_tpu/__main__.py:31-78``,
    defaults ``:366-382``): 16 views in window mode "slide"."""
    from structure_from_motion_tpu_torch.config import (
        CapacityConfig,
        FrontendConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )

    return PipelineConfig(
        frontend=FrontendConfig(
            detector="dog", max_keypoints=2048, descriptor_dim=128,
            upsample_first_octave=True, num_octaves=5,
        ),
        matcher=MatcherConfig(
            ratio=0.75, metric="l2", cross_check=False, use_fundamental_gate=True,
            gate_ransac=RansacConfig(inlier_threshold=3.0, iteration=128),
        ),
        capacity=CapacityConfig(
            max_views=16, max_keypoints=2048, max_points=16384, max_observations=65536
        ),
        window_size=16,
        window_mode="slide",
    )


def long_sequence_config():
    """The engine configuration of ``examples/run_long_sequence.py`` (window
    8, 1024 keypoints, BA iterations 3, damping 5, Huber 0.01) at the
    capacities of the 500-camera checkpoint."""
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
        capacity=CapacityConfig(
            max_views=8, max_keypoints=1024, max_points=8192, max_observations=32768
        ),
        window_size=8,
        window_mode="slide",
    )


def write_bmp_gray(path, gray) -> None:
    """(H, W) uint8 -> an uncompressed bottom-up 24-bit BMP file."""
    import numpy as np

    h, w = gray.shape
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : 3 * w] = np.repeat(gray[::-1], 3, axis=1)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0))
        f.write(rows.tobytes())


def _reset(counted) -> None:
    for fn in counted.values():
        fn.launches = 0
        getattr(fn, "by_shape", {}).clear()


def _read(counted):
    return ({name: fn.launches for name, fn in counted.items()},
            {name: dict(fn.by_shape) for name, fn in counted.items() if hasattr(fn, "by_shape")})


def _run_cli(argv) -> tuple:
    """``__main__.main(argv)`` in this process -> (exit code, its stdout)."""
    from structure_from_motion_tpu_torch.__main__ import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, out.getvalue()


def cli_phase(dev, imgs, small_imgs, K, small_K, C_gt, small_C_gt, cfg, counted, sync,
              card: str):
    """The command line on BMP files, on ``dev`` ("cuda" in the smoke, "cpu"
    in a rehearsal); raises when a check fails. Returns the launch counts
    (all, by shape) of the 600x800 run with ``topk_block`` 0, the path of
    the B2 map kernel."""
    import dataclasses

    import numpy as np

    from structure_from_motion_tpu_torch.io.colmap import read_colmap_text
    from structure_from_motion_tpu_torch.io.datasets import load_image_grayscale
    from structure_from_motion_tpu_torch.io.ply import read_ply
    from structure_from_motion_tpu_torch.io.prefetch import DevicePrefetcher
    from structure_from_motion_tpu_torch.io.tum import load_tum_trajectory
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    device = str(dev).split(":")[0]
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    n_first, n_all = len(imgs) - 4, len(imgs)
    for name, frames in (("first", imgs[:n_first]), ("all", imgs), ("small", small_imgs)):
        (root / name).mkdir(parents=True)
        for i, im in enumerate(frames):
            write_bmp_gray(str(root / name / f"frame{i:04d}.bmp"), np.asarray(im))
    out = root / "out"

    def argv(images, Km, *extra):
        return ["reconstruct", "--images", str(root / images), "--pattern", "*.bmp",
                "--out", str(out), "--fx", repr(float(Km[0, 0])), "--fy", repr(float(Km[1, 1])),
                "--cx", repr(float(Km[0, 2])), "--cy", repr(float(Km[1, 2])),
                "--device", device, *extra]

    def quality(n, cfg=cfg, K=K, C_gt=C_gt):
        """ATE and mean reprojection of the run under ``out`` over n frames."""
        rec = np.load(out / "reconstruction.npz")
        locs, rots = rec["locations"], rec["rotations"]
        if locs.shape != (n, 3) or not (np.isfinite(locs).all() and np.isfinite(rots).all()):
            raise AssertionError(f"reconstruction.npz holds {locs.shape} poses, expected {n}")
        span = float(np.linalg.norm(C_gt[:n].max(0) - C_gt[:n].min(0)))
        ate = _umeyama_ate(locs, C_gt[:n]) / span
        engine = IncrementalSfM(cfg, K, frontend="native", device=dev)
        engine.load_checkpoint(str(out / "state.npz"))
        reproj = engine.reprojection_error()
        if not (ate < ATE_BOUND and reproj < REPROJ_BOUND_PX):
            raise AssertionError(f"CLI quality outside its bounds: ATE {ate}, {reproj} px")
        return locs, rots, rec["points"], ate, reproj, engine

    # -- reconstruct at the default flags, with the exports and checkpoints
    _reset(counted)
    rc, text = _run_cli(argv("first", K, "--export-tum", "--export-ply", "--export-colmap",
                             "--checkpoint-every", "8"))
    sync()
    launches, _ = _read(counted)
    print(text.rstrip())
    if rc != 0:
        raise AssertionError(f"reconstruct exited with {rc}")
    rate = [ln for ln in text.splitlines() if "frames/s" in ln]
    print(f"cli reconstruct: {rate[0].strip()} ({card})")
    locs, rots, pts, ate, reproj, engine = quality(n_first)
    if len(engine._archive) != n_first - cfg.window_size:
        raise AssertionError(f"{len(engine._archive)} views archived in the CLI run")
    ts, tum_C, tum_R = load_tum_trajectory(str(out / "trajectory.tum"))
    xyz, _ = read_ply(str(out / "reconstruction.ply"))
    model = read_colmap_text(str(out / "colmap"))
    # the files hold 9 (TUM), ~7 (PLY, f32) and 12 (COLMAP) digits
    exports_ok = (
        np.array_equal(ts, np.arange(n_first))
        and np.abs(tum_C - locs).max() < 1e-6 and np.abs(tum_R - rots).max() < 1e-5
        and len(xyz) == len(pts) + n_first and np.abs(xyz[len(pts):] - locs).max() < 1e-4
        and np.abs(xyz[:len(pts)] - pts).max() < 1e-4
        and np.abs(model["locs"] - locs).max() < 1e-5 and np.abs(model["rots"] - rots).max() < 1e-5
        and model["names"] == [f"frame{i:04d}.bmp" for i in range(n_first)]
        and len(model["points"]) == len(pts)
    )
    print(f"cli quality over {n_first} frames: ATE {ate:.5f} of span (bound {ATE_BOUND}), "
          f"reprojection {reproj:.4f} px (bound {REPROJ_BOUND_PX}), {len(pts)} map points, "
          f"{len(engine._archive)} views archived; TUM, PLY and COLMAP read back to the same "
          f"poses: {exports_ok}; launches {launches}")
    if not exports_ok:
        raise AssertionError("an export does not read back to the poses of reconstruction.npz")
    main_kernels = ("B1 blur_levels", "B2f candidate_block_max", "B3 match_top2", "B4 ba_blocks")
    if any(launches[k] < 1 for k in main_kernels) or launches["B2 candidate_response"]:
        raise AssertionError(f"CLI launches: {launches}")

    # -- resume on a directory with 4 more frames
    _reset(counted)
    rc, text = _run_cli(argv("all", K, "--resume", "--export-tum"))
    sync()
    launches, _ = _read(counted)
    print(text.rstrip())
    resumed = f"resumed at frame {n_first} (input file {n_first})" in text
    if rc != 0 or not resumed or f"frame{n_first - 1:04d}.bmp:" in text:
        raise AssertionError(f"--resume: exit {rc}, started at input {n_first}: {resumed}")
    _, _, _, ate, reproj, engine = quality(n_all)
    print(f"cli resume: started at input {n_first}, {n_all} poses, ATE {ate:.5f} of span, "
          f"reprojection {reproj:.4f} px; launches {launches}")
    if any(launches[k] < 1 for k in main_kernels):
        raise AssertionError(f"resume launches: {launches}")

    # -- the prefetcher against a plain loop: host wall time per frame
    files = sorted(str(f) for f in (root / "first").glob("*.bmp"))[:12]
    medians = {}
    for mode in ("prefetcher", "plain loop", "plain loop", "prefetcher"):
        engine = IncrementalSfM(cfg, K, frontend="native", device=dev)
        feed = (DevicePrefetcher(files, load_image_grayscale, device=device)
                if mode == "prefetcher" else ((f, load_image_grayscale(f)) for f in files))
        times, t0 = [], time.perf_counter()
        for _, img in feed:
            engine.process_image(img)
            sync()
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        medians.setdefault(mode, []).append(float(np.median(times[2:])))
    print(f"cli ingest: median host wall time a frame (frames 2-{len(files) - 1}, decode and upload "
          f"included, two runs each): with the prefetcher {medians['prefetcher']} s, with a plain "
          f"loop {medians['plain loop']} s ({card})")

    # -- selftest, and the B2 map kernel's path: --config with topk_block 0
    rc, text = _run_cli(["selftest", "--device", device])
    print(f"cli {text.strip()}")
    if rc != 0:
        raise AssertionError("selftest failed")
    map_cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, topk_block=0))
    (root / "map_config.json").write_text(map_cfg.to_json())
    _reset(counted)
    rc, text = _run_cli(argv("small", small_K, "--config", str(root / "map_config.json")))
    sync()
    map_launches, map_by_shape = _read(counted)
    if rc != 0 or map_launches["B2f candidate_block_max"]:
        raise AssertionError(f"the --config run exited with {rc} or took the fused kernel")
    _, _, pts, ate, reproj, _ = quality(len(small_imgs), map_cfg, small_K, small_C_gt)
    print(f"cli --config (topk_block 0, {len(small_imgs)} frames of "
          f"{small_imgs[0].shape[0]}x{small_imgs[0].shape[1]}): ATE {ate:.5f} of span (bound "
          f"{ATE_BOUND}), reprojection {reproj:.4f} px (bound {REPROJ_BOUND_PX}), {len(pts)} map "
          f"points; launches {map_launches}, by shape {map_by_shape}")
    shutil.rmtree(root)
    return map_launches, map_by_shape


def slice_phase(dev, imgs, K, C_gt, cfg, counted, sync, card: str) -> dict:
    """Frames through the engine in slide mode, then ``finalize_global``;
    raises when a bound fails. Returns the launch counts of the phase and,
    for the wrappers that tally them, the counts by shape.
    ``card`` (name and power limit) is printed beside every time."""
    import numpy as np

    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    n = len(imgs)
    window = cfg.window_size
    _reset(counted)
    engine = IncrementalSfM(cfg, K, frontend="native", seed=0, device=dev)
    frame_s = []
    for im in imgs:
        t0 = time.perf_counter()
        info = engine.process_image(im)
        sync()
        frame_s.append(time.perf_counter() - t0)
        print(f"slice frame {info['frame']}: {frame_s[-1]:.3f} s, matches {int(info['matches'])}, "
              f"pnp_inliers {int(info['pnp_inliers'])}, new_points {int(info['new_points'])}, "
              f"reprojection {info['reprojection_px']:.4f} px ({card})")
    locs, _ = engine.poses()
    span = float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))
    ate_before = _umeyama_ate(locs, C_gt)
    reproj_before = engine.reprojection_error()
    t0 = time.perf_counter()
    ginfo = engine.finalize_global(iterations=20)
    sync()
    global_s = time.perf_counter() - t0
    launches, by_shape = _read(counted)
    print(f"slice launches: {launches}")
    print(f"slice launches by shape: {by_shape}")
    print(f"slice frame time: first (frame 0) {frame_s[0]:.3f} s, bootstrap (frame 1) "
          f"{frame_s[1]:.3f} s, frames 2-{window - 1} median "
          f"{float(np.median(frame_s[2:window])):.3f} s, frames {window}-{n - 1} (evicting) "
          f"median {float(np.median(frame_s[window:])):.3f} s, total {sum(frame_s):.3f} s ({card})")
    locs, rots = engine.poses()
    ate_after = _umeyama_ate(locs, C_gt)
    reproj = engine.reprojection_error()
    costs = ginfo["costs"]
    print(f"slice finalize_global: {ginfo['n_cams']} cameras ({len(engine._archive)} archived), "
          f"{ginfo['n_points']} points, {ginfo['n_obs']} observations, {ginfo['slots']} slots, "
          f"{global_s:.3f} s ({card}), cost {costs[0]:.6g} -> {costs[-1]:.6g}")
    print(f"slice quality: ATE before global BA {ate_before:.5f} = {ate_before / span:.5f} "
          f"of span, after {ate_after:.5f} = {ate_after / span:.5f} (bound {ATE_BOUND}, "
          f"after <= 1.05 x before + 1e-6), reprojection {reproj_before:.4f} -> {reproj:.4f} px "
          f"(bound {REPROJ_BOUND_PX}), map points {len(engine.map_points())}")
    if not (locs.shape == (n, 3) and np.isfinite(locs).all() and np.isfinite(rots).all()):
        raise AssertionError("poses missing or not finite")
    if len(engine._archive) != n - window:
        raise AssertionError(f"{len(engine._archive)} views archived, expected {n - window}")
    if not (ate_before / span < ATE_BOUND and ate_after / span < ATE_BOUND
            and ate_after <= 1.05 * ate_before + 1e-6 and reproj < REPROJ_BOUND_PX):
        raise AssertionError("slice quality outside its bounds")

    # checkpoint round trip (a file in the checkout's build directory) and
    # the live-window finalize, after the counts were read
    ck = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint.npz"
    ck.parent.mkdir(parents=True, exist_ok=True)
    engine.save_checkpoint(str(ck))
    resumed = IncrementalSfM(cfg, K, frontend="native", seed=0, device=dev)
    resumed_frame = resumed.load_checkpoint(str(ck))
    ck.unlink()
    same = all(np.array_equal(a, b) for a, b in zip(resumed.poses(), engine.poses()))
    fcosts = engine.finalize(iterations=3)
    print(f"slice checkpoint: resumed at frame {resumed_frame}, poses equal {same}; "
          f"finalize(3) cost {fcosts[0]:.6g} -> {fcosts[-1]:.6g}")
    if not (resumed_frame == n and same and np.isfinite(fcosts).all()):
        raise AssertionError("checkpoint round trip or finalize failed")
    return launches, by_shape


def global_phase(dev, counted, sync, card: str) -> dict:
    """``finalize_global(iterations=20)`` on the 500-camera checkpoint;
    raises when a bound fails. Returns the launch counts of the phase.
    ``card`` (name and power limit) is printed beside every time."""
    import numpy as np

    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    engine = IncrementalSfM(long_sequence_config(), np.eye(3), frontend="precomputed",
                            device=dev)
    frame = engine.load_checkpoint(str(ARTIFACT))
    print(f"global: checkpoint at frame {frame}, {len(engine._archive)} archived views")
    _reset(counted)
    sync()
    t0 = time.perf_counter()
    info = engine.finalize_global(iterations=20)
    sync()
    wall = time.perf_counter() - t0
    launches, _ = _read(counted)
    costs = [float(c) for c in info["costs"]]
    print(f"global problem: V {info['n_cams']}, points {info['n_points']}, observations "
          f"{info['n_obs']}, max track {info['max_track_len']}, slots {info['slots']}, "
          f"tiers {info['tiers']}")
    print(f"global CG iterations per LM step: {info['cg_iterations']}")
    print(f"global costs: {[round(c, 6) for c in costs]}")
    print(f"global wall time (synchronised, 20 LM iterations, assembly included): {wall:.3f} s "
          f"({card})")
    print(f"global launches: {launches}")
    locs, rots = engine.poses()
    orth = float(np.abs(np.einsum("fij,fkj->fik", rots, rots) - np.eye(3)).max())
    print(f"global quality: final cost {costs[-1]:.6f} (bound 1.05 x {JAX_GLOBAL_COST} = "
          f"{1.05 * JAX_GLOBAL_COST:.6f}), final / first {costs[-1] / costs[0]:.4f} (bound 0.3), "
          f"{len(locs)} poses, max |R R^T - I| {orth:.2e} (bound 1e-4)")
    if not (locs.shape == (500, 3) and np.isfinite(locs).all() and np.isfinite(rots).all()
            and orth <= 1e-4):
        raise AssertionError("global poses missing, not finite or not orthonormal")
    if not (costs[-1] <= 1.05 * JAX_GLOBAL_COST and costs[-1] <= 0.3 * costs[0]):
        raise AssertionError("global cost outside its bounds")
    cg = list(info["cg_iterations"])
    if len(cg) != len(GLOBAL_CG_ITERATIONS) or any(
            abs(a - b) > 2 for a, b in zip(cg, GLOBAL_CG_ITERATIONS)):
        raise AssertionError(f"CG iterations {cg} not within 2 of {GLOBAL_CG_ITERATIONS}")
    for name in ("B4 ba_blocks", "B5 expand_cam", "B6 reduce_cam"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched in the global solve: {launches}")
    return launches


def kernel_phase(dev, imgs, small_img, cfg, smi: str) -> list:
    """Every kernel against its plain version on the card at the shapes its
    path gives it; raises on a disagreement. Returns the kernels' entries
    (without ``launches``; ``path`` names the run whose launches count)."""
    import dataclasses

    import numpy as np
    import torch

    from structure_from_motion_tpu_torch.models import global_ba
    from structure_from_motion_tpu_torch.ops import ba, ba_cuda, ba_matvec, blur_cuda
    from structure_from_motion_tpu_torch.ops import features, features_cuda, matching
    from structure_from_motion_tpu_torch.utils import checkpoint

    fe = cfg.frontend
    img = torch.as_tensor(imgs[0]).to(dev).to(torch.float32)
    img = img / img.max()
    S = fe.scales_per_octave
    sig = [fe.sigma0 * 2.0 ** (i / S) for i in range(S + 3)]
    rel = [features._gaussian_kernel1d(math.sqrt(s**2 - sig[0] ** 2)) for s in sig[1:]]
    rng = np.random.default_rng(0)
    results = []

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def record(name, src, replaces, err, tol, fn, plain, ok, *, moved, flops,
               flop_rate=PEAK_F32_FLOPS, library=None, shape=None, path="slice"):
        """``moved``: bytes the function must move (inputs once, outputs
        once); ``flops``: its operations at ``flop_rate``; ``library``: one
        PyTorch call computing the same function, where there is one;
        ``shape``: the wrapper's ``by_shape`` key, where its launches are
        tallied by shape; ``path``: the run that launches it ("slice",
        "global", or "cli map" for the CLI run with ``topk_block`` 0)."""
        ms, plain_ms = _median_ms(torch, fn), _median_ms(torch, plain)
        library_ms = _median_ms(torch, library) if library is not None else None
        t_bytes, t_ops = 1e3 * moved / PEAK_BYTES_PER_S, 1e3 * flops / flop_rate
        bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        print(f"kernel {name}: max_abs_err={err:.3e} ({tol}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), library "
              f"{'none' if library_ms is None else f'{library_ms:.4f} ms'} ({smi})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        results.append(dict(name=name, route="cuda",
                            source=f"structure_from_motion_tpu_torch/csrc/{src}",
                            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                            shape=shape, path=path))

    # B1 and B2 at every shape a frame launches them at: the base blur (one
    # level over the upsampled image), then each octave's five levels and its
    # DoG stack, every shape against the plain version with its own bound.
    # B1: two separable passes of 2r + 1 taps a level; B2: ~40 compares and a
    # 2x2 Hessian test per output value
    def b1_case(label, src_img, ks, path="slice"):
        got = blur_cuda.blur_levels(src_img, ks)
        ref = blur_cuda.blur_levels_reference(src_img, ks)
        err = float((got - ref).abs().max())
        h, w = src_img.shape
        record(f"B1 blur_levels{label}", "blur.cu",
               "structure_from_motion_tpu/ops/blur_pallas.py:85", err,
               f"atol 2e-5; {h}x{w}, radii {[len(k) // 2 for k in ks]}",
               lambda: blur_cuda.blur_levels(src_img, ks),
               lambda: blur_cuda.blur_levels_reference(src_img, ks), err <= 2e-5,
               moved=nbytes(src_img, got), flops=sum(2 * 2 * len(k) for k in ks) * src_img.numel(),
               shape=(h, w, len(ks)), path=path)
        return got

    up = features._upsample2x(img).contiguous()
    base_k = [features._gaussian_kernel1d(math.sqrt(fe.sigma0**2 - 1.0))]
    base = b1_case(f" (base blur, {up.shape[0]}x{up.shape[1]}, 1 level)", up, base_k)[0]
    args = (fe.contrast_threshold, fe.edge_threshold, 8)
    cand_src = "structure_from_motion_tpu/ops/features_pallas.py:95"

    def b2f_equal(stack, a=args):
        """Fused B2 against its plain version, bit for bit; two launches."""
        got = features_cuda.candidate_block_max(stack, *a)
        again = features_cuda.candidate_block_max(stack, *a)
        ref = features_cuda.candidate_block_max_reference(stack, *a)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        return got, ref, torch.equal(got[0], ref[0]), torch.equal(got[1], ref[1]), same

    for octave in range(fe.num_octaves):
        h, w = base.shape
        label = "" if octave == 0 else f" ({h}x{w})"
        gauss = torch.cat([base[None], b1_case(label, base, rel)])
        dog = (gauss[1:] - gauss[:-1]).contiguous()
        got, ref, cand_ok, pos_ok, same = b2f_equal(dog)
        err = float((got[0] - ref[0]).abs().max())
        record(f"B2f candidate_block_max{label}", "cand.cu", cand_src, err,
               f"atol 0 (cand equal bits: {cand_ok}, pos equal: {pos_ok}, two launches same "
               f"bits: {same}); ({dog.shape[0]}, {h}, {w}), {int((ref[0] > 0).sum())} of "
               f"{ref[0].numel()} blocks hold a candidate",
               lambda: features_cuda.candidate_block_max(dog, *args),
               lambda: features_cuda.candidate_block_max_reference(dog, *args),
               cand_ok and pos_ok and same, moved=nbytes(dog, *got),
               flops=40 * (dog.shape[0] - 2) * h * w, shape=(h, w))
        if octave == 0:
            # the whole candidate stage, the map kernel and the four
            # reductions that followed it against the fused kernel alone
            def old_stage():
                r = features_cuda.candidate_response(dog, *args)
                r4 = r.reshape(r.shape[0], h, w // 8, 8)
                r5 = r4.amax(dim=3).reshape(r.shape[0], h // 8, 8, w // 8)
                return r5.amax(dim=2), torch.argmax(r4, dim=3), torch.argmax(r5, dim=2)

            old_ms = _median_ms(torch, old_stage)
            new_ms = _median_ms(torch, lambda: features_cuda.candidate_block_max(dog, *args))
            print(f"kernel B2 candidate stage at ({dog.shape[0]}, {h}, {w}): map kernel + four "
                  f"reductions {old_ms:.4f} ms, fused kernel {new_ms:.4f} ms by events ({smi})")
        if octave == 2:
            # ties and empty blocks: the stack quantised to steps of 1/64,
            # every test but the extremum wide open (contrast 0, border 1)
            tied = (torch.round(dog * 64.0) / 64.0).contiguous()
            targs = (0.0, 1e6, 1)
            got, ref, cand_ok, pos_ok, same = b2f_equal(tied, targs)
            full = features_cuda.candidate_response_reference(tied, *targs)
            blocks = full.reshape(full.shape[0], h // 8, 8, w // 8, 8)
            n_max = (blocks == blocks.amax(dim=(2, 4), keepdim=True)).sum(dim=(2, 4))
            n_tied = int(((n_max > 1) & (ref[0] > 0)).sum())
            n_zero = int((ref[0] == 0).sum())
            print(f"kernel B2f ties: ({tied.shape[0]}, {h}, {w}) quantised to 1/64: {n_tied} "
                  f"blocks with several equal maxima, {n_zero} all-zero blocks of "
                  f"{ref[0].numel()}; cand equal bits {cand_ok}, pos equal {pos_ok}, two "
                  f"launches same bits {same}")
            if not (cand_ok and pos_ok and same and n_tied > 100 and n_zero > 100
                    and bool((ref[1][ref[0] == 0] == 0).all())):
                raise AssertionError("fused B2 disagrees with its plain version on ties")
        base = features._downsample2(gauss[S])
    # fused B2 at other layer counts and ragged widths (whole and partial
    # warps; the paths above give it S = 3 only)
    for s2, h, w in ((3, 64, 128), (4, 72, 200), (6, 136, 264), (5, 8, 8)):
        stack = torch.as_tensor((rng.normal(size=(s2, h, w)) * 0.05).astype(np.float32)).to(dev)
        stack = ((stack + stack.roll(1, 1) + stack.roll(1, 2)) / 3).contiguous()
        _, ref, cand_ok, pos_ok, same = b2f_equal(stack)
        print(f"kernel B2f ragged: ({s2}, {h}, {w}): {int((ref[0] > 0).sum())} candidates, cand "
              f"equal bits {cand_ok}, pos equal {pos_ok}, two launches same bits {same}")
        if not (cand_ok and pos_ok and same):
            raise AssertionError("fused B2 disagrees with its plain version on a ragged shape")

    # the B2 kernel that writes the whole map: the path for topk_block <= 1
    # and for sizes 8 does not divide. Every shape a 600x800 frame launches
    # it and B1 at (the CLI run with topk_block 0), one entry a shape
    small = torch.as_tensor(small_img).to(dev).to(torch.float32)
    up = features._upsample2x(small / small.max()).contiguous()
    base = b1_case(f" (base blur, {up.shape[0]}x{up.shape[1]}, 1 level)", up, base_k,
                   "cli map")[0]
    for octave in range(fe.num_octaves):
        h, w = base.shape
        gauss = torch.cat([base[None], b1_case(f" ({h}x{w})", base, rel, "cli map")])
        dog = (gauss[1:] - gauss[:-1]).contiguous()
        got = features_cuda.candidate_response(dog, *args)
        ref = features_cuda.candidate_response_reference(dog, *args)
        err = float((got - ref).abs().max())
        record(f"B2 candidate_response ({h}x{w})", "cand.cu", cand_src, err,
               f"atol 0 (exact); ({dog.shape[0]}, {h}, {w}), {int((got > 0).sum())} "
               "candidates",
               lambda: features_cuda.candidate_response(dog, *args),
               lambda: features_cuda.candidate_response_reference(dog, *args), err == 0.0,
               moved=nbytes(dog, got), flops=40 * got.numel(), shape=(h, w), path="cli map")
        if octave == 1:
            # a block other than 8: the map kernel, then two reductions;
            # the same candidates as the plain versions on the CPU
            fe4 = dataclasses.replace(fe, topk_block=4)
            on_card = features._octave_candidates(gauss, fe4, 512)[1:]
            on_cpu = features._octave_candidates(gauss.cpu(), fe4, 512)[1:]
            same = all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
            print(f"kernel B2 topk_block 4 at ({dog.shape[0]}, {h}, {w}): "
                  f"{int(on_cpu[-1].sum())} candidates, equal to the CPU's: {same}")
            if not (same and int(on_cpu[-1].sum()) > 100):
                raise AssertionError("topk_block 4 on the card disagrees with the CPU")
        base = features._downsample2(gauss[S])
    del gauss, dog, up, small

    # B3: 16 views x 2048 reference rows against 2048 query rows, D = 128;
    # unit-norm rows (the tolerance is stated for unit-norm descriptors: the
    # pipeline's x512 scale multiplies every d^2 and its rounding by 512^2)
    def descriptors(n):
        d = np.abs(rng.normal(size=(n, 128))).astype(np.float32)
        return torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True)).to(dev)

    def b3_check(ref_d, que_d, mask_q, scale):
        """(max abs error of d^2, within tolerance and j1 equal on separated
        rows, two launches same bits) at ``scale`` x the unit-norm tolerance."""
        g = matching.match_top2(ref_d, que_d, mask_q)
        g_again = matching.match_top2(ref_d, que_d, mask_q)
        r1, r2, rj = matching.match_top2_reference(ref_d, que_d, mask_q)
        err = float(max((g[0] - r1).abs().max(), (g[1] - r2).abs().max()))
        close = all(bool(((a - b).abs() <= scale * 1e-4 + 1e-5 * b.abs()).all())
                    for a, b in ((g[0], r1), (g[1], r2)))
        same_j = bool((g[2] == rj)[(r2 - r1) > scale * 1e-3].all())
        return err, close and same_j, all(torch.equal(a, b) for a, b in zip(g, g_again))

    ref_d, que_d = descriptors(16 * 2048), descriptors(2048)
    mask_q = torch.as_tensor(rng.random(2048) < 0.9).to(dev)
    product_ms = _median_ms(torch, lambda: ref_d @ que_d.T)
    print(f"kernel B3 information: ref @ que.T alone ({tuple(ref_d.shape)} x "
          f"{tuple(que_d.shape)}^T, f32 with TF32 off, the (Nr, Nq) matrix written to device "
          f"memory) {product_ms:.4f} ms; not the kernel's function, never called by the port "
          f"({smi})")
    err, ok, same = b3_check(ref_d, que_d, mask_q, 1.0)
    # the function needs the products of the valid queries only; on the
    # tensor cores at f32-level accuracy each is three TF32 products
    n_valid_q = int(mask_q.sum())
    record("B3 match_top2", "match_top2.cu", "structure_from_motion_tpu/ops/matching.py:220",
           err, "d^2 rtol 1e-5 atol 1e-4, j1 equal where d2^2-d1^2 > 1e-3; "
           f"two launches same bits: {same}",
           lambda: matching.match_top2(ref_d, que_d, mask_q),
           lambda: matching.match_top2_reference(ref_d, que_d, mask_q), ok and same,
           moved=nbytes(ref_d, que_d, mask_q) + 12 * ref_d.shape[0],
           flops=3 * 2 * ref_d.shape[0] * n_valid_q * 128, flop_rate=PEAK_TF32_FLOPS)

    # B3 at the pipeline's own scale: x512 descriptors of rendered frames
    # (4 reference views against the fifth), tolerance x 512^2, and the
    # matcher's decisions on every row whose top two are separated
    feats = [features.detect_and_describe(torch.as_tensor(im).to(dev), fe) for im in imgs[:5]]
    ref_f = torch.stack([d for _, d in feats[:4]]).contiguous()
    mask_r = torch.stack([k.mask for k, _ in feats[:4]])
    que_f, mask_f = feats[4][1].contiguous(), feats[4][0].mask
    sc = 512.0**2
    flat = ref_f.reshape(-1, 128)
    err, ok, same = b3_check(flat, que_f, mask_f, sc)
    gj = matching.match_top2(flat, que_f, mask_f)[2].view(mask_r.shape).long()
    r1, r2, rj = (t.view(mask_r.shape) for t in matching.match_top2_reference(flat, que_f, mask_f))
    # separated: neither the nearest neighbour nor the ratio test is within
    # the tolerance of flipping, and (dedup couples the rows of a view) no
    # unseparated row of the same view claims the same query
    ratio = cfg.matcher.ratio
    sep = ((r2 - r1) > sc * 1e-3) \
        & ((torch.sqrt(r1) - ratio * torch.sqrt(r2)).abs() > 1e-3 * torch.sqrt(r2))
    view = torch.arange(sep.shape[0], device=dev)[:, None].expand_as(sep)
    contested = torch.zeros(sep.shape[0], que_f.shape[0], dtype=torch.bool, device=dev)
    for j in (gj, rj.long()):
        contested[view[~sep], j[~sep]] = True
    row_ok = sep & ~contested[view, rj.long()]
    got_m = matching.match_descriptors(ref_f, que_f, mask_r, mask_f, cfg.matcher)
    want_m = matching.match_descriptors(*(t.cpu() for t in (ref_f, que_f, mask_r, mask_f)),
                                        cfg.matcher)
    agree = bool((got_m.valid == want_m.valid.to(dev))[row_ok].all()
                 and (got_m.target == want_m.target.to(dev))[row_ok].all())
    print(f"kernel B3 at the pipeline's scale (x512 descriptors of rendered frames, "
          f"{ref_f.shape[0]} x {ref_f.shape[1]} against {que_f.shape[0]}): max_abs_err={err:.3e} "
          f"(d^2 rtol 1e-5 atol 1e-4 x 512^2 = {sc * 1e-4:.1f}), within tolerance {ok}, two "
          f"launches same bits {same}; match_descriptors: {int(got_m.valid.sum())} matches "
          f"(plain version on the CPU {int(want_m.valid.sum())}), valid and target equal on "
          f"all {int(row_ok.sum())} separated rows of {row_ok.numel()}: {agree}")
    if not (ok and same and agree and int(row_ok.sum()) > row_ok.numel() // 2):
        raise AssertionError("B3 disagrees with its plain version at the pipeline's scale")
    del feats, ref_f, que_f, got_m, want_m

    def b4_case(name, bargs, path="slice"):
        """B4 against its plain version, two launches bit for bit."""
        O, V = bargs[0].shape[0], bargs[6]
        got = ba_cuda.ba_blocks(*bargs)
        again = ba_cuda.ba_blocks(*bargs)
        ref = ba_cuda.ba_blocks_reference(*bargs)
        errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        scaled = [e / max(1.0, float(b.abs().max())) for e, b in zip(errs, ref)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        # per observation 56 B in and 132 B out, per camera 57 floats out;
        # ~400 FLOPs of closed form per observation
        record(name, "ba_blocks.cu", "structure_from_motion_tpu/ops/ba_pallas.py:163",
               max(errs), f"1e-3 x max(1, |value|); worst scaled {max(scaled):.2e}; O = {O}, "
               f"V = {V}; two launches same bits: {same}",
               lambda: ba_cuda.ba_blocks(*bargs), lambda: ba_cuda.ba_blocks_reference(*bargs),
               max(scaled) <= 1e-3 and same,
               moved=nbytes(*bargs[:6], *got[2:5]) + 4 * 57 * V, flops=400 * O, path=path)
        return got

    def b4_random(O, V):
        cam = torch.as_tensor(rng.integers(0, V, O).astype(np.int32)).to(dev)
        Cv = rng.normal(size=(V, 3)).astype(np.float32)
        qv = (np.float32([1, 0, 0, 0]) + 0.05 * rng.normal(size=(V, 4))).astype(np.float32)
        X = (rng.normal(size=(O, 3)) * [3, 2, 1] + [0, 0, 10]).astype(np.float32)
        c = cam.cpu().numpy()
        uv = ((X[:, :2] - Cv[c, :2]) / (X[:, 2:] - Cv[c, 2:])
              + 0.003 * rng.normal(size=(O, 2))).astype(np.float32)
        w = (rng.random(O) < 0.3).astype(np.float32)
        return (cam, *(torch.as_tensor(a).to(dev) for a in (Cv[c], qv[c], X, uv, w)), V, 0.01)

    # B4: the full ELL stream, 16384 points x 16 slots, V = 16
    b4_case("B4 ba_blocks", b4_random(16384 * 16, 16))

    # ragged shapes, which the paths above never give: partial blocks and
    # tiles, and B4 camera ids outside [0, V) (they enter no camera sum;
    # the kernel's cost is the sum of the cameras' shares, so it is held
    # against the plain cost of the observations that have a camera)
    for O, V in ((1000, 3), (77, 40), (130, 200)):
        bargs = b4_random(O, V)
        foreign = torch.as_tensor(rng.random(O) < 0.1).to(dev)
        cam = torch.where(foreign, torch.full_like(bargs[0], V + 2), bargs[0])
        cam[::7] = torch.where(foreign[::7], -1, cam[::7])
        bargs = (cam, *bargs[1:])
        got = ba_cuda.ba_blocks(*bargs)
        ref = ba_cuda.ba_blocks_reference(*bargs)
        own = ba_cuda.ba_blocks_reference(*(a[~foreign] for a in bargs[:6]), V, 0.01)
        worst = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                    for a, b in zip(got, (*ref[:5], own[5])))
        print(f"kernel B4 ragged: O = {O}, V = {V}, {int(foreign.sum())} foreign ids: worst "
              f"scaled error {worst:.2e} (1e-3)")
        if not worst <= 1e-3:
            raise AssertionError("B4 disagrees with its plain version on a ragged shape")
    for nr, nq in ((1000, 300), (130, 64), (64, 5)):
        err, ok, same = b3_check(descriptors(nr), descriptors(nq),
                                 torch.as_tensor(rng.random(nq) < 0.8).to(dev), 1.0)
        print(f"kernel B3 ragged: {nr} x {nq}: max_abs_err={err:.3e}, within tolerance {ok}, "
              f"two launches same bits {same}")
        if not (ok and same):
            raise AssertionError("B3 disagrees with its plain version on a ragged shape")
    del ref_d, que_d

    # B4, B5, B6 at the global solve's shape: the tiered stream of the
    # 500-camera checkpoint (233,984 slots, V = 500); B4 also at the same O
    # with V = 16, to show how its time depends on V
    state, frame, archive, _ = checkpoint.load_state(str(ARTIFACT), dev)
    prob = global_ba.build_global_problem(state, archive, min(frame, 8))
    st, obs, tiers, _, cam_rows = global_ba.tiered_problem(prob)
    lay = ba.ObsLayout(tiers=tiers, pad=obs.cam.shape[0] - sum(n * r for n, r in tiers))
    O, V = obs.cam.shape[0], st.C.shape[0]
    gcam = obs.cam.contiguous()
    gl = gcam.long()
    bargs = (gcam, st.C[gl].contiguous(), st.q[gl].contiguous(),
             ba._point_gather(st.X, lay).contiguous(), obs.uv_norm.contiguous(),
             obs.valid.to(torch.float32), V, 0.01)
    print(f"kernel global shape: O = {O} slots, V = {V}, tiers {tiers}, cam_rows {cam_rows}")
    got = b4_case("B4 ba_blocks (global shape)", bargs, "global")
    b4_case("B4 ba_blocks (global O, V = 16)", b4_random(O, 16), "global")
    w21 = got[3].reshape(O, 21)
    x = torch.as_tensor(rng.normal(size=(V, 7)).astype(np.float32)).to(dev)
    t = ba_matvec.expand_cam(gcam, w21, x)
    t_ref = ba_matvec.expand_cam_reference(gcam, w21, x)
    err = float((t - t_ref).abs().max())
    bound = 1e-5 * max(1.0, float(t_ref.abs().max()))
    record("B5 expand_cam", "ba_matvec.cu", "structure_from_motion_tpu/ops/ba_matvec_pallas.py:91",
           err, f"1e-5 x max(1, |t|) = {bound:.3e}",
           lambda: ba_matvec.expand_cam(gcam, w21, x),
           lambda: ba_matvec.expand_cam_reference(gcam, w21, x), err <= bound,
           moved=nbytes(gcam, w21, x, t), flops=2 * 21 * O, path="global")
    y = torch.as_tensor(rng.normal(size=(O, 3)).astype(np.float32)).to(dev)
    perm, mask = ba.compute_cam_ell(gcam, obs.valid, V, cam_rows)
    c1 = ba_matvec.reduce_cam(w21, y, perm, mask, V)
    c2 = ba_matvec.reduce_cam(w21, y, perm, mask, V)
    c_ref = ba_matvec.reduce_cam_reference(w21, y, perm, mask, V)
    err = float((c1 - c_ref).abs().max())
    bound = 1e-4 * max(1.0, float(c_ref.abs().max()))
    same = bool(torch.equal(c1, c2))
    # the function reads the W and y rows of the filled slots only
    n_filled = int(mask.sum())
    record("B6 reduce_cam", "ba_matvec.cu",
           "structure_from_motion_tpu/ops/ba_matvec_pallas.py:125",
           err, f"1e-4 x max(1, |coup|) = {bound:.3e}; two launches same bits: {same}",
           lambda: ba_matvec.reduce_cam(w21, y, perm, mask, V),
           lambda: ba_matvec.reduce_cam_reference(w21, y, perm, mask, V), err <= bound and same,
           moved=n_filled * (84 + 12) + nbytes(perm, mask, c1), flops=2 * 21 * n_filled,
           path="global")
    torch.cuda.empty_cache()
    return results


def main() -> None:
    import torch

    # -- 1. environment ----------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import structure_from_motion_tpu_torch as port

    # the port under test is the checkout this script sits in, never an
    # installed copy elsewhere
    if Path(port.__file__).resolve().parents[1] != Path(__file__).resolve().parent:
        raise SystemExit(f"chip_smoke: run from the repository root (found {port.__file__})")
    from structure_from_motion_tpu_torch import kernels
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence
    from structure_from_motion_tpu_torch.ops import ba_cuda, ba_matvec, blur_cuda
    from structure_from_motion_tpu_torch.ops import features_cuda, matching

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(
        f"environment: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the f32 policy")
    dev = torch.device("cuda")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}")
    log = path.with_suffix(".log")
    if log.exists():  # what ptxas said of each kernel
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                print(f"build ptxas: {line.strip()}")

    # -- 3. kernels against their plain versions at the paths' shapes ------
    imgs, K, C_gt, _ = synthetic_scene_sequence(**RENDER)
    small_imgs, small_K, small_C_gt, _ = synthetic_scene_sequence(**RENDER_SMALL)
    cfg = cli_default_config()
    results = kernel_phase(dev, imgs, small_imgs[0], cfg, smi)

    # -- 4. the slice: the CLI's default slide mode, then finalize_global ----
    slice_kernels = {
        "B1 blur_levels": blur_cuda.blur_levels,
        "B2f candidate_block_max": features_cuda.candidate_block_max,
        "B3 match_top2": matching.match_top2,
        "B4 ba_blocks": ba_cuda.ba_blocks,
    }
    counted = dict(slice_kernels, **{"B2 candidate_response": features_cuda.candidate_response,
                                     "B5 expand_cam": ba_matvec.expand_cam,
                                     "B6 reduce_cam": ba_matvec.reduce_cam})
    runs = {"slice": slice_phase(dev, imgs, K, C_gt, cfg, counted, torch.cuda.synchronize, smi)}
    launches = runs["slice"][0]
    missing = [name for name in slice_kernels if launches[name] < 1]
    if missing:
        raise AssertionError(f"a kernel of the slice never launched: {missing}")
    if launches["B2f candidate_block_max"] != cfg.frontend.num_octaves * len(imgs) \
            or launches["B2 candidate_response"]:
        raise AssertionError(f"the slice's candidate stage is not the fused kernel's: {launches}")

    # -- 5. the 500-camera global solve --------------------------------------
    runs["global"] = (global_phase(dev, counted, torch.cuda.synchronize, smi), {})

    # -- 6. the command line ---------------------------------------------------
    runs["cli map"] = cli_phase(dev, imgs, small_imgs, K, small_K, C_gt, small_C_gt, cfg,
                                counted, torch.cuda.synchronize, smi)
    for r in results:
        name = r["name"].split(" (")[0]
        shape, (all_launches, by_shape) = r.pop("shape"), runs[r.pop("path")]
        # B1, B2: the launches at this entry's shape; else all of the run's
        r["launches"] = all_launches[name] if shape is None else by_shape[name].get(shape, 0)
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} never launched on its path")
    foreign = sorted(k for k in sys.modules
                     if k in ("jax", "jaxlib", "structure_from_motion_tpu")
                     or k.startswith("structure_from_motion_tpu."))
    if foreign:
        raise AssertionError(f"the port imported JAX or the JAX package: {foreign}")

    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
