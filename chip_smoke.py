#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing its numbers on its own line; any failure raises and
the script exits non-zero without printing the final result line:

1. environment: a CUDA card must be visible; prints its nvidia-smi name and
   power limit, the torch/CUDA versions and both TF32 switches;
2. build: compiles ``structure_from_motion_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernels (run last, after the runs whose BA inputs it takes): each of the
   Hopper kernels against its plain PyTorch
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
   same O with V = 16; B3, B4 and B6 must give the same bits twice; each
   B4 entry also prints the device time of each of its kernels (the
   one-lane ``ba_reduce_rows<false>`` or the lane ``<true>``) with the
   registers ``ptxas`` gave it;
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

7. batched: ``BatchedIncrementalSfM`` at the CLI's default config with
   B = 8 lanes, lane b on its own rendered 960x1280 sequence
   (``synthetic_scene_sequence(10, (960, 1280), seed=3 + b, loops=0.7)``),
   10 frames: every lane held to the ATE and reprojection bounds, lanes 0
   and 7 against ``IncrementalSfM(seed=b)`` runs on the same frames (poses
   to atol 5e-3), the synchronised wall time a frame, aggregate frames/s,
   kernel launches and host synchronisations a frame at B = 8 and at B = 1
   (lane 0 alone, same frames); then the same engine at ``bench.py``'s small
   config (256 keypoints, 3 octaves, no 2x, capacities 8 / 256 / 2048 /
   8192) on 8 lanes of 8 rendered 240x320 frames, held to bands fixed from
   the JAX package on the same frames on the CPU; then 3 frames of 8 lanes
   of 600x800 with ``topk_block`` 0 (the map kernel's lane path);
8. Harris: ``reconstruct --detector harris`` in-process on 10 rendered
   600x800 frames written as BMP files, held to bands fixed from the JAX
   package's CLI on the same frames on the CPU;
9. sharded BA (after phase 5): two ranks on this ONE card in a gloo group
   over CUDA tensors (NCCL refuses two ranks on one GPU), spawned fresh:
   (a) ``finalize_global(20, num_shards=2)`` on the 500-camera checkpoint,
   held to phase 5's limits and to its single-device solve (final cost
   within 2%, similarity-aligned camera centres within 1e-3 of span); (b) ``IncrementalSfM(ba_num_shards=2)``
   on the slice's first 8 frames against the single engine on them (poses
   atol 5e-3, both within the slice's ATE and reprojection bounds); every
   rank's poses the same bits (by hash); then a one-rank NCCL group through
   ``sharded_bundle_adjustment`` (S = 1, the hybrid layout) on the same
   global problem. Each rank counts its own launches (set to 0 just before
   each run, read just after; the entries sum both ranks') and rank 0 saves
   its last B4, B5 and B6 inputs for the kernel phase. Two ranks share one
   card's SMs: their times are no multi-GPU speed;
10. shared sampling: ``reconstruct --config`` at the CLI's default flags
   with ``"sampling": "shared"`` on the Harris phase's BMP frames, held to
   bands fixed from the JAX package's CLI on the same frames on the CPU,
   then ``BatchedIncrementalSfM`` with it on 2 lanes of the small batch
   against their single runs (poses atol 5e-3).

11. serve (right after phase 4, on its frames): a fresh engine at the
   slice's config with ``image_shape`` (960, 1280) exported by
   ``serve.export_engine`` (the native frame step, eviction, reprojection,
   the 10-iteration finalize: the default programs but the
   precomputed-feature frame step, which the CPU tests serve) into
   ``build/``; a live engine and the served one over the 24 frames (the
   two taking turns frame by frame, so both meet the same host), equal
   bit for bit in every state field, the eviction archive and the
   reprojection, within the slice's bounds; the same launches of B1, B2f,
   B3 and B4 in both runs (the exported programs run the kernels as
   ``sfm::`` operators); the served ``finalize``; the artifact served in a
   spawned process with ``ops.pnp.estimate_pnp`` and the frame step made to
   raise; export, save, load, draw and frame times, and the served/live
   ratio of the steady frame split into device and host time (the last
   frame of each under ``torch.profiler``; no time gate: the host is
   shared).

12. loops (after phase 10): the LM and PCG loops stop on the device
   (``utils/control.masked_loop``: a stop mask read once every k steps,
   each chunk of k steps one CUDA graph replay). Every loop call of one
   steady slice frame (frame ``LOOP_FRAME``: PnP's LO rounds, prior,
   polish and refinement, the triangulation) and of one batched frame at
   B = 8 through the graph path against the plain per-step loop
   (``masked_loop_reference``) on the same inputs, bit for bit, with the
   steps each call took; the 500-camera solve again with the plain PCG
   loop: CG counts, costs and poses equal to phase 5's, and both wall
   times; k, captures, replays, stop-mask reads, the graph pool's memory,
   and host synchronisations a frame of the slice and at B = 8 and B = 1.

13. frame graph (right after phase 4): the slice's detect + match stretch
   (``models/incremental._front_stage``, no host read from the image to
   the recorded matches) is ONE CUDA graph (``utils/control.graphed``):
   frame 0 eager, frame 1 captured, every later frame one replay. The 24
   frames again with every frame eager, against phase 4's run: every state
   field after every frame, every statistic and every archive record equal
   bit for bit; the graph's captures and replays; the host
   synchronisations of a steady and of an evicting frame by call site.

Kernel B7 (``csrc/svd.cu``: the frame path's small SVDs, no host read;
no Pallas kernel stands behind it) joins phase 3 at every shape the slice
called it with eagerly, and on the numpy cases of
``tools/svd_cases.cases`` (65,536 x 12 in one launch, a refit with 90% of
its rows zero, two close smallest singular values, degenerate samples):
against ``torch.linalg.svd`` under the sign rule (null vectors to 1e-3
where the two smallest singular values are apart, everywhere a unit vector
no worse in ``|A v|``; the 3 x 3 factors to 1e-3 and rebuilding A), with no
host synchronisation, the same bits twice, a tall matrix's launch replayed
twice from a CUDA graph with the eager bits, ``torch.linalg.svd``'s time as
its library call, and the minimal PnP margin of
``tests/test_torch_geometry.py`` on that test's 6-point samples (B7's
median centre error < 1 and 5x below the f32 gram null vector's).

Phase 6 also decodes its BMP files through the native loader
(``io/native_loader.PrefetchingLoader``, ``native/sfm_loader.cpp`` built by
``make``), which must build here, against ``io/datasets``' decode (atol
1e-3).

The kernel phase also holds the lane axis of B1, B2f, the B2 map kernel,
B3 and B4 at B = 8 and the batched phases' shapes (the full-width run, the
small batch with its last BA stream, the map run): each against its plain
version, lane b against a one-lane launch on lane b's inputs, and a
one-lane stack against the call without a lane axis, bit for bit; and B1
and B4 at the Harris run's shapes (per octave the sigma 1.0 and 2.0
one-level blurs and the three structure-tensor lanes of the sigma 1.5
blur; its last BA stream), and B4, B5 and B6 at the sharded runs' shapes
(rank 0's last inputs: a shard's hybrid ELL + tail stream of the global
solve, a shard of the per-frame BA; B5 and B6 there held entry by entry to
the sum of their products' magnitudes, as the last CG direction of a
sharded solve can be large enough for its products to cancel). Each entry's launches are read from
the run that launches it at that shape. The
slice, CLI and batched phases end with ``utils/debug.validate_state`` on
their states and fail on any finding. The frames render in worker
processes, joined at the end.

Every phase's launch counts are set to 0 just before it and read just
after; a loop graph's replay counts the kernels the graph holds (B5 and B6
in the PCG chunk), and the phases print captures and replays beside the
counts. Last, ``torch.library.opcheck`` holds every ``sfm::`` operator with
CUDA inputs at one small shape. The last two lines are a JSON object of the kernels' numbers and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import multiprocessing
import shutil
import struct
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

# 0.07 loops per frame, the motion of tests/test_synthetic_gt.py:77-79
RENDER = dict(n_frames=24, size=(960, 1280), seed=3, loops=1.68)
# a frame size whose deeper octaves (300x400 and below) 8 does not divide
RENDER_SMALL = dict(n_frames=6, size=(600, 800), seed=3, loops=0.42)
ATE_BOUND = 0.05  # of the trajectory span (tests/test_synthetic_gt.py:86-90)
# the batched phases: lane b renders with seed 3 + b
BATCH = 8
BATCH_RENDER = dict(n_frames=10, size=(960, 1280), loops=0.7)
SMALL_BATCH_RENDER = dict(n_frames=8, size=(240, 320), loops=0.56)
HARRIS_RENDER = dict(n_frames=10, size=(600, 800), seed=3, loops=0.7)
# the JAX package on the CPU on the same frames (PERF.md section 4 says how):
# BatchedIncrementalSfM at bench.py's small config, worst of its 8 lanes
JAX_SMALL_BATCH = dict(ate=0.00890743828249003, reproj=0.4068412482738495, points=316)
# its CLI with --detector harris (Pallas blur pinned where the shapes allow)
JAX_HARRIS = dict(ate=0.0009084704780323498, reproj=0.7060211896896362, points=2999)
SMALL_BATCH_BANDS = dict(ate=3.0 * JAX_SMALL_BATCH["ate"], reproj=2.0 * JAX_SMALL_BATCH["reproj"],
                         points=int(0.75 * JAX_SMALL_BATCH["points"]))
HARRIS_BANDS = dict(ate=5.0 * JAX_HARRIS["ate"], reproj=1.25 * JAX_HARRIS["reproj"],
                    points=(int(0.8 * JAX_HARRIS["points"]), int(1.2 * JAX_HARRIS["points"])))
# its CLI at the default (DoG) flags with "sampling": "shared", same frames
JAX_SHARED = dict(ate=0.0006536381272132246, reproj=0.17416368424892426, points=2716)
SHARED_BANDS = dict(ate=5.0 * JAX_SHARED["ate"], reproj=1.25 * JAX_SHARED["reproj"],
                    points=(int(0.8 * JAX_SHARED["points"]), int(1.2 * JAX_SHARED["points"])))
# the sharded phase: two ranks on the one card (gloo), S = 2
SHARDS = 2
SHARDED_FRAMES = 8
REPROJ_BOUND_PX = 2.0
# phase 12: the steady frame of the slice (and of the batched run) whose
# loop calls are held to the plain loop
LOOP_FRAME = 12
BATCHED_LOOP_FRAME = 5
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


def small_batch_config():
    """``bench.py``'s small-sequence config (``bench.py:284-312``): 256
    keypoints, 3 octaves without the 2x octave, ratio 0.8, capacities 8 /
    256 / 2048 / 8192."""
    from structure_from_motion_tpu_torch.config import (
        CapacityConfig,
        FrontendConfig,
        MatcherConfig,
        PipelineConfig,
    )

    return PipelineConfig(
        frontend=FrontendConfig(max_keypoints=256, num_octaves=3, upsample_first_octave=False),
        matcher=MatcherConfig(ratio=0.8),
        capacity=CapacityConfig(max_views=8, max_keypoints=256, max_points=2048,
                                max_observations=8192),
    )


def render_all(pool) -> dict:
    """Every rendered sequence of the smoke, submitted to ``pool``: name ->
    future of ``synthetic_scene_sequence``'s (imgs, K, C_gt, R_gt)."""
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence

    jobs = {"slice": RENDER, "small": RENDER_SMALL, "harris": HARRIS_RENDER}
    for b in range(BATCH):
        jobs[f"lane{b}"] = dict(BATCH_RENDER, seed=3 + b)
        jobs[f"small lane{b}"] = dict(SMALL_BATCH_RENDER, seed=3 + b)
    return {name: pool.submit(synthetic_scene_sequence, **kw) for name, kw in jobs.items()}


def _validated(state, what: str) -> None:
    from structure_from_motion_tpu_torch.utils.debug import validate_state

    problems = validate_state(state)
    print(f"{what} validate_state: {len(problems)} findings {problems[:5]}")
    if problems:
        raise AssertionError(f"{what}: the state breaks its invariants: {problems[:5]}")


def _span_ate(locs, C_gt) -> float:
    import numpy as np

    return _umeyama_ate(locs, C_gt) / float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))


def batched_phase(dev, seqs, small_seqs, map_seq, cfg, counted, sync, card: str,
                  loops: LoopRecorder) -> dict:
    """``BatchedIncrementalSfM`` on B lanes: the CLI's default config at full
    width (every lane held to the slice's bounds, two lanes against single
    runs, launches and host synchronisations a frame at B and at 1), then
    ``bench.py``'s small config, then the map kernel's lane path. Returns
    the launch counts (all, by shape) of the full-width B-lane run, of the
    small batch and of the map run, under "batched", "small batch" and
    "batched map", and the small batch's last B4 inputs. ``loops`` keeps
    the loop calls of frame ``BATCHED_LOOP_FRAME`` of the full-width run
    and the host synchronisations a frame at B and at 1."""
    import dataclasses

    import numpy as np
    import torch

    from structure_from_motion_tpu_torch.models.batched import BatchedIncrementalSfM
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
    from structure_from_motion_tpu_torch.ops import ba as ba_module

    B = len(seqs)
    seeds = list(range(B))

    def lockstep(config, lanes, K, label, lane_seeds, record=None):
        """Every frame of ``lanes`` (each (imgs, ...)) through one engine:
        (engine, wall s a frame, host synchronisations a frame, launches);
        ``record`` names the run whose loop calls ``loops`` keeps."""
        n = len(lanes[0][0])
        frames = [torch.as_tensor(np.stack([np.asarray(s[0][t]) for s in lanes])).to(dev)
                  for t in range(n)]
        eng = BatchedIncrementalSfM(config, K, batch=len(lanes), seed=lane_seeds, device=dev)
        sync()
        _reset(counted)
        times, syncs = [], []
        for t in range(n):
            loops.on = record if t == BATCHED_LOOP_FRAME else None
            with _counting_syncs(syncs, dev):
                t0 = time.perf_counter()
                info = eng.process_images(frames[t])
                sync()
                times.append(time.perf_counter() - t0)
            print(f"{label} frame {t}: {times[-1]:.3f} s, host synchronisations {syncs[-1]}, "
                  f"matches {info['matches'].tolist()}, reprojection "
                  f"{np.round(info['reprojection_px'], 4).tolist()} px ({card})")
        loops.on = None
        return eng, times, syncs, _read(counted)

    K = seqs[0][1]
    if not all(np.allclose(s[1], K) for s in seqs):
        raise AssertionError("the lanes' renders do not share K")
    n = len(seqs[0][0])
    eng, times, syncs, (launches, by_shape) = lockstep(cfg, seqs, K, f"batched B={B}", seeds,
                                                       record=f"batched B={B}")
    locs, rots = eng.poses()
    reproj = eng.reprojection_error()
    ates = [_span_ate(locs[b], seqs[b][2]) for b in range(B)]
    steady = float(np.median(times[2:]))
    print(f"batched B={B} ({n} frames of {seqs[0][0][0].shape[0]}x{seqs[0][0][0].shape[1]} a "
          f"lane): frame 0 {times[0]:.3f} s, bootstrap {times[1]:.3f} s, frames 2-{n - 1} "
          f"median {steady:.3f} s, total {sum(times):.3f} s, aggregate "
          f"{B * n / sum(times):.2f} frames/s, steady {B / steady:.2f} frames/s ({card})")
    print(f"batched B={B} quality: ATE of span {np.round(ates, 5).tolist()} (bound {ATE_BOUND}), "
          f"reprojection {np.round(reproj, 4).tolist()} px (bound {REPROJ_BOUND_PX}), map points "
          f"{[len(eng.map_points(b)) for b in range(B)]}")
    print(f"batched B={B} launches: {launches}; by shape {by_shape}; {_loop_stats()}")
    if not (locs.shape == (B, n, 3) and np.isfinite(locs).all() and np.isfinite(rots).all()):
        raise AssertionError("batched poses missing or not finite")
    if not (max(ates) < ATE_BOUND and float(reproj.max()) < REPROJ_BOUND_PX):
        raise AssertionError("a batched lane is outside the slice's bounds")
    _validated(eng.state, f"batched B={B}")
    for name in ("B1 blur_levels", "B2f candidate_block_max", "B3 match_top2", "B4 ba_blocks"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched in the batched run")

    # lane 0 alone through the same engine: launches and synchronisations
    _, times1, syncs1, (launches1, _) = lockstep(cfg, seqs[:1], K, "batched B=1", seeds[:1])
    loops.syncs[f"batched B={B}"], loops.syncs["batched B=1"] = syncs, syncs1
    per = {k: round(v / n, 1) for k, v in launches.items()}
    per1 = {k: round(v / n, 1) for k, v in launches1.items()}
    print(f"batched launches a frame of the counted kernels: B={B} {per}, B=1 {per1}; host "
          f"synchronisations a frame: B={B} {syncs} (median {float(np.median(syncs[2:]))}), "
          f"B=1 {syncs1} (median {float(np.median(syncs1[2:]))}); B=1 wall median "
          f"{float(np.median(times1[2:])):.3f} s a frame ({card})")

    # two lanes against single-sequence runs with their seeds
    for b in (0, B - 1):
        single = IncrementalSfM(cfg, K, frontend="native", seed=seeds[b], device=dev)
        for im in seqs[b][0]:
            single.process_image(im)
        s_locs, s_rots = single.poses()
        dl, dr = float(np.abs(locs[b] - s_locs).max()), float(np.abs(rots[b] - s_rots).max())
        print(f"batched lane {b} against IncrementalSfM(seed={seeds[b]}): max |dC| {dl:.2e}, "
              f"max |dR| {dr:.2e} (atol 5e-3)")
        if not (dl <= 5e-3 and dr <= 5e-3):
            raise AssertionError(f"batched lane {b} differs from its single run")
    del eng

    # bench.py's small config: 8 lanes of 240x320
    scfg = small_batch_config()
    with last_call(ba_module, "ba_blocks") as small_b4:
        eng, times, syncs, small_counts = lockstep(scfg, small_seqs, small_seqs[0][1],
                                                   f"small batch B={B}", seeds)
    locs, _ = eng.poses()
    ates = [_span_ate(locs[b], small_seqs[b][2]) for b in range(B)]
    reproj = eng.reprojection_error()
    points = [len(eng.map_points(b)) for b in range(B)]
    ns = len(small_seqs[0][0])
    print(f"small batch B={B}: frames 2-{ns - 1} median {float(np.median(times[2:])):.3f} s, "
          f"aggregate {B * ns / sum(times):.2f} frames/s, host synchronisations {syncs} ({card}); "
          f"ATE of span {np.round(ates, 5).tolist()} (bound {SMALL_BATCH_BANDS['ate']:.5f}), "
          f"reprojection {np.round(reproj, 4).tolist()} px (bound "
          f"{SMALL_BATCH_BANDS['reproj']:.4f}), map points {points} (at least "
          f"{SMALL_BATCH_BANDS['points']}); launches {small_counts[0]}, by shape "
          f"{small_counts[1]}")
    if not (max(ates) <= SMALL_BATCH_BANDS["ate"] and float(reproj.max())
            <= SMALL_BATCH_BANDS["reproj"] and min(points) >= SMALL_BATCH_BANDS["points"]):
        raise AssertionError("the small batch is outside the JAX package's bands")
    _validated(eng.state, f"small batch B={B}")
    del eng

    # the map kernel's lane path: topk_block 0 on 600x800 frames
    map_cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, topk_block=0))
    eng, _, _, (map_launches, map_by_shape) = lockstep(map_cfg, map_seq, map_seq[0][1],
                                                       f"batched map B={B}", seeds)
    print(f"batched map B={B}: launches {map_launches}, by shape {map_by_shape}")
    if map_launches["B2 candidate_response"] < 1 or map_launches["B2f candidate_block_max"]:
        raise AssertionError("the batched map run did not take the map kernel")
    if not np.isfinite(eng.poses()[0]).all():
        raise AssertionError("batched map run: poses not finite")
    _validated(eng.state, f"batched map B={B}")
    runs = {"batched": (launches, by_shape), "small batch": small_counts,
            "batched map": (map_launches, map_by_shape)}
    return runs, small_b4["args"]


def harris_phase(dev, seq, counted, sync, card: str):
    """``reconstruct --detector harris`` on BMP files, held to the bands of
    the JAX package's CLI on the same frames. Returns its launch counts
    (all, by shape), its frontend config and its last B4 inputs."""
    import numpy as np

    from structure_from_motion_tpu_torch.config import PipelineConfig
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
    from structure_from_motion_tpu_torch.ops import ba as ba_module

    imgs, K, C_gt, _ = seq
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_harris"
    shutil.rmtree(root, ignore_errors=True)
    (root / "frames").mkdir(parents=True)
    for i, im in enumerate(imgs):
        write_bmp_gray(str(root / "frames" / f"frame{i:04d}.bmp"), np.asarray(im))
    out = root / "out"
    _reset(counted)
    with last_call(ba_module, "ba_blocks") as b4_in:
        rc, text = _run_cli(["reconstruct", "--images", str(root / "frames"), "--pattern",
                             "*.bmp", "--out", str(out), "--fx", repr(float(K[0, 0])),
                             "--fy", repr(float(K[1, 1])), "--cx", repr(float(K[0, 2])),
                             "--cy", repr(float(K[1, 2])), "--detector", "harris"])
        sync()
    launches, by_shape = _read(counted)
    print(text.rstrip())
    if rc != 0:
        raise AssertionError(f"reconstruct --detector harris exited with {rc}")
    rec = np.load(out / "reconstruction.npz")
    locs, pts = rec["locations"], rec["points"]
    cfg = PipelineConfig.from_json((out / "config.json").read_text())
    engine = IncrementalSfM(cfg, K, frontend="native", device=dev)
    engine.load_checkpoint(str(out / "state.npz"))
    ate, reproj = _span_ate(locs, C_gt), engine.reprojection_error()
    lo, hi = HARRIS_BANDS["points"]
    rate = [ln for ln in text.splitlines() if "frames/s" in ln]
    print(f"harris: {rate[0].strip() if rate else ''} ({card}); {len(locs)} poses, ATE of span "
          f"{ate:.6f} (bound {HARRIS_BANDS['ate']:.6f}), reprojection {reproj:.4f} px (bound "
          f"{HARRIS_BANDS['reproj']:.4f}), {len(pts)} map points (band {lo}-{hi}); JAX on the "
          f"CPU: {JAX_HARRIS}; launches {launches}, by shape {by_shape}")
    if not (cfg.frontend.detector == "harris" and cfg.matcher.metric == "hamming"
            and cfg.matcher.cross_check and cfg.frontend.descriptor_dim == 256):
        raise AssertionError(f"the harris run's config is not the JAX parser's: {cfg}")
    if not (len(locs) == len(imgs) and np.isfinite(locs).all() and ate <= HARRIS_BANDS["ate"]
            and reproj <= HARRIS_BANDS["reproj"] and lo <= len(pts) <= hi):
        raise AssertionError("the harris run is outside the JAX package's bands")
    if launches["B1 blur_levels"] < 1 or launches["B4 ba_blocks"] < 1:
        raise AssertionError(f"harris launches: {launches}")
    _validated(engine.state, "harris")
    shutil.rmtree(root)
    return (launches, by_shape), cfg.frontend, b4_in["args"]


def shared_phase(dev, seq, small_lanes, counted, sync, card: str):
    """``sampling="shared"``: ``reconstruct --config`` at the CLI's default
    (DoG) flags with the shared grid on BMP files, held to bands around the
    JAX package's CLI on the same frames (not to the slice's absolute
    bounds: the JAX config records that shared sampling loses quality on
    rendered texture); then a batched small-batch run with it, 2 lanes
    against their single runs."""
    import dataclasses

    import numpy as np

    from structure_from_motion_tpu_torch.config import PipelineConfig
    from structure_from_motion_tpu_torch.models.batched import BatchedIncrementalSfM
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    imgs, K, C_gt, _ = seq
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_shared"
    shutil.rmtree(root, ignore_errors=True)
    (root / "frames").mkdir(parents=True)
    for i, im in enumerate(imgs):
        write_bmp_gray(str(root / "frames" / f"frame{i:04d}.bmp"), np.asarray(im))
    cfg = cli_default_config()
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, sampling="shared"))
    (root / "config.json").write_text(cfg.to_json())
    out = root / "out"
    _reset(counted)
    rc, text = _run_cli(["reconstruct", "--images", str(root / "frames"), "--pattern", "*.bmp",
                         "--out", str(out), "--fx", repr(float(K[0, 0])), "--fy",
                         repr(float(K[1, 1])), "--cx", repr(float(K[0, 2])), "--cy",
                         repr(float(K[1, 2])), "--config", str(root / "config.json"),
                         "--device", str(dev).split(":")[0]])
    sync()
    launches, by_shape = _read(counted)
    print(text.rstrip())
    if rc != 0:
        raise AssertionError(f"reconstruct with sampling 'shared' exited with {rc}")
    rec = np.load(out / "reconstruction.npz")
    locs, pts = rec["locations"], rec["points"]
    ran = PipelineConfig.from_json((out / "config.json").read_text())
    engine = IncrementalSfM(ran, K, frontend="native", device=dev)
    engine.load_checkpoint(str(out / "state.npz"))
    ate, reproj = _span_ate(locs, C_gt), engine.reprojection_error()
    lo, hi = SHARED_BANDS["points"]
    rate = [ln for ln in text.splitlines() if "frames/s" in ln]
    print(f"shared: {rate[0].strip() if rate else ''} ({card}); {len(locs)} poses, ATE of span "
          f"{ate:.6f} (bound {SHARED_BANDS['ate']:.6f}), reprojection {reproj:.4f} px (bound "
          f"{SHARED_BANDS['reproj']:.4f}), {len(pts)} map points (band {lo}-{hi}); JAX on the "
          f"CPU: {JAX_SHARED}; launches {launches}, by shape {by_shape}")
    if ran.frontend.sampling != "shared":
        raise AssertionError(f"the run's config does not sample a shared grid: {ran.frontend}")
    if not (len(locs) == len(imgs) and np.isfinite(locs).all() and ate <= SHARED_BANDS["ate"]
            and reproj <= SHARED_BANDS["reproj"] and lo <= len(pts) <= hi):
        raise AssertionError("the shared-sampling run is outside the JAX package's bands")
    for name in ("B1 blur_levels", "B2f candidate_block_max", "B2 candidate_response",
                 "B3 match_top2", "B4 ba_blocks"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched in the shared-sampling run: {launches}")
    _validated(engine.state, "shared")
    shutil.rmtree(root)

    # the batched engine with the shared grid: 2 lanes of the small batch
    scfg = small_batch_config()
    scfg = dataclasses.replace(scfg, frontend=dataclasses.replace(scfg.frontend,
                                                                  sampling="shared"))
    lanes = small_lanes[:2]
    eng = BatchedIncrementalSfM(scfg, lanes[0][1], batch=2, seed=[0, 1], device=dev)
    for t in range(len(lanes[0][0])):
        eng.process_images(np.stack([np.asarray(s[0][t]) for s in lanes]))
    locs, rots = eng.poses()
    for b in range(2):
        single = IncrementalSfM(scfg, lanes[b][1], frontend="native", seed=b, device=dev)
        for im in lanes[b][0]:
            single.process_image(im)
        s_locs, s_rots = single.poses()
        dl, dr = float(np.abs(locs[b] - s_locs).max()), float(np.abs(rots[b] - s_rots).max())
        print(f"shared batched small batch, lane {b} against IncrementalSfM(seed={b}): max |dC| "
              f"{dl:.2e}, max |dR| {dr:.2e} (atol 5e-3); ATE of span "
              f"{_span_ate(locs[b], lanes[b][2]):.5f}")
        if not (dl <= 5e-3 and dr <= 5e-3):
            raise AssertionError(f"shared batched lane {b} differs from its single run")
    _validated(eng.state, "shared batched")


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


@contextlib.contextmanager
def last_call(module, name: str):
    """Keep the arguments of the last call of ``module.name`` made in the
    block: the inputs a path gave a kernel's wrapper, whose launches still
    count as the path's own."""
    fn = getattr(module, name)
    seen = {}

    def spy(*args):
        seen["args"] = args
        return fn(*args)

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def svd_inputs(seen: dict):
    """Keep in ``seen`` a copy of the last input of every kernel B7 call
    made eagerly in the block (a CUDA graph's replays call no wrapper), by
    its ``by_shape`` key ``(batch, M, N, full)``."""
    import torch

    from structure_from_motion_tpu_torch.ops import small_svd as S

    fn = S.small_svd

    def spy(A, null_only=False):
        if A.is_cuda and not torch.cuda.is_current_stream_capturing():
            M, N = A.shape[-2:]
            seen[(A.numel() // (M * N), M, N, not null_only)] = A.detach().clone()
        return fn(A, null_only)

    S.small_svd = spy
    try:
        yield seen
    finally:
        S.small_svd = fn


@contextlib.contextmanager
def _clock(name: str):
    """Print the wall time of one phase of the smoke."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def _reset(counted) -> None:
    from structure_from_motion_tpu_torch.utils import control

    control.reset_stats()
    for fn in counted.values():
        fn.launches = 0
        getattr(fn, "by_shape", {}).clear()


def _read(counted):
    return ({name: fn.launches for name, fn in counted.items()},
            {name: dict(fn.by_shape) for name, fn in counted.items() if hasattr(fn, "by_shape")})


@contextlib.contextmanager
def _counting_syncs(out: list, dev, sites: list | None = None):
    """Append the host synchronisations torch reports in the block to
    ``out`` (none counted off the card), and their count by call site
    (``tools/slice_frames.sync_site``) to ``sites`` when given."""
    if not str(dev).startswith("cuda"):
        yield
        out.append(0)
        if sites is not None:
            sites.append({})
        return
    from structure_from_motion_tpu_torch.tools.slice_frames import host_syncs

    with host_syncs() as found:
        yield
    out.append(sum(found.values()))
    if sites is not None:
        sites.append(dict(found.most_common()))


def _loop_stats() -> str:
    """What the loop graphs did since the last :func:`_reset`."""
    from structure_from_motion_tpu_torch.utils import control

    s = control.stats
    return (f"loop graphs {s.captures} captures ({s.capture_s:.3f} s), {s.replays} replays, "
            f"{s.reads} stop-mask reads, pool +{s.pool_bytes / 2**20:.1f} MiB, buffers "
            f"{s.static_bytes / 2**20:.2f} MiB")


def _b4_kernels(torch, fn, smi: str, label: str, bound_ms: float) -> None:
    """Print the device time of each kernel of one B4 call (ba_assemble and
    the instantiation of ba_reduce_rows it launches) with its registers a
    thread, beside the function's bound."""
    from structure_from_motion_tpu_torch import kernels
    from structure_from_motion_tpu_torch.tools.profile_kernels import device_times

    log = kernels.library_path().with_suffix(".log")
    regs = kernels.ptxas_registers(log.read_text()) if log.exists() else {}
    for _ in range(3):  # a trace now and then comes back without device records
        parts = device_times(fn, every=True)
        if any(k.startswith("ba_") for k in parts):
            break
    print(f"kernel {label} by kernel: "
          + ", ".join(f"{k} {us:.2f} us ({regs.get(k, ('?',))[0]} registers)"
                      for k, us in parts.items() if k.startswith("ba_"))
          + f"; bound of the function {bound_ms:.4f} ms ({smi})")


class LoopRecorder:
    """Keeps a copy of the arguments of every ``control.masked_loop`` call
    the ops modules make while ``on`` names a run (phase 12 replays them),
    and the host synchronisations a frame of the runs that count them."""

    def __init__(self):
        self.on, self.calls, self.syncs = None, {}, {}

    @contextlib.contextmanager
    def installed(self):
        import torch
        from torch.utils import _pytree as pytree

        from structure_from_motion_tpu_torch.ops import linalg, pnp, triangulation
        from structure_from_motion_tpu_torch.utils import control

        def spy(n, k, step_fn, carried, *operands, capture=True):
            if self.on is not None:
                copy = lambda t: t.clone() if torch.is_tensor(t) else t  # noqa: E731
                self.calls.setdefault(self.on, []).append(
                    (n, k, step_fn, pytree.tree_map(copy, tuple(carried)),
                     pytree.tree_map(copy, operands), capture))
            return control.masked_loop(n, k, step_fn, carried, *operands, capture=capture)

        modules = (pnp, triangulation, linalg)
        for m in modules:
            m.masked_loop = spy
        try:
            yield self
        finally:
            for m in modules:
                m.masked_loop = control.masked_loop


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
        _validated(engine.state, f"cli ({n} frames)")
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

    # -- the native loader (native/sfm_loader.cpp, built by make) on the BMPs
    from structure_from_motion_tpu_torch.io import native_loader

    if not native_loader.native_available():
        raise AssertionError("the native loader did not build (make, g++)")
    t0 = time.perf_counter()
    with native_loader.PrefetchingLoader(files, n_threads=4) as ld:
        native = list(ld)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = [load_image_grayscale(f) for f in files]
    t_python = time.perf_counter() - t0
    diff = max(float(np.abs(a - b).max()) for a, b in zip(native, python))
    exact = float(np.mean([np.mean(a == b) for a, b in zip(native, python)]))
    direct = native_loader.decode_grayscale(files[0])
    print(f"cli native loader: {len(files)} BMP frames of {native[0].shape} through "
          f"PrefetchingLoader in {t_native:.3f} s, io/datasets in {t_python:.3f} s (host); max "
          f"|native - python| {diff:.2e} (atol 1e-3), {100 * exact:.2f}% of pixels equal; "
          "decode_grayscale equal to the loader's frame: "
          f"{direct is not None and np.array_equal(direct, native[0])}")
    if not (diff <= 1e-3 and direct is not None and np.array_equal(direct, native[0])):
        raise AssertionError("the native loader disagrees with io/datasets")

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


def slice_phase(dev, imgs, K, C_gt, cfg, counted, sync, card: str,
                loops: LoopRecorder | None = None, keep: dict | None = None) -> dict:
    """Frames through the engine in slide mode, then ``finalize_global``;
    raises when a bound fails. Returns the launch counts of the phase and,
    for the wrappers that tally them, the counts by shape. ``loops``, when
    given, keeps frame ``LOOP_FRAME``'s loop calls and the host
    synchronisations a frame. ``keep``, when given, receives every frame's
    state (copies on the device), statistics and host synchronisations by
    site, the archive and the frame graph's captures and replays, before
    the global solve. ``card`` (name and power limit) is printed beside
    every time."""
    import numpy as np

    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
    from structure_from_motion_tpu_torch.utils import control

    n = len(imgs)
    window = cfg.window_size
    _reset(counted)
    engine = IncrementalSfM(cfg, K, frontend="native", seed=0, device=dev)
    frame_s, syncs, sites, states, infos = [], [], [], [], []
    for t, im in enumerate(imgs):
        if loops is not None:
            loops.on = "slice" if t == LOOP_FRAME else None
        with _counting_syncs(syncs, dev, sites):
            t0 = time.perf_counter()
            info = engine.process_image(im)
            sync()
            frame_s.append(time.perf_counter() - t0)
        if keep is not None:
            states.append([x.clone() for x in engine.state])
            infos.append(info)
        print(f"slice frame {info['frame']}: {frame_s[-1]:.3f} s, matches {int(info['matches'])}, "
              f"pnp_inliers {int(info['pnp_inliers'])}, new_points {int(info['new_points'])}, "
              f"reprojection {info['reprojection_px']:.4f} px, host synchronisations "
              f"{syncs[-1]} ({card})")
    if loops is not None:
        loops.on = None
        loops.syncs["slice"] = syncs
    if keep is not None:
        keep.update(states=states, infos=infos, sites=sites, syncs=syncs,
                    archive=list(engine._archive), graph=(control.stats.call_captures,
                                                         control.stats.call_replays))
    locs, _ = engine.poses()
    span = float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))
    ate_before = _umeyama_ate(locs, C_gt)
    reproj_before = engine.reprojection_error()
    t0 = time.perf_counter()
    ginfo = engine.finalize_global(iterations=20)
    sync()
    global_s = time.perf_counter() - t0
    launches, by_shape = _read(counted)
    print(f"slice launches: {launches}; {_loop_stats()}")
    print(f"slice launches by shape: {by_shape}")
    print(f"slice frame time: first (frame 0) {frame_s[0]:.3f} s, bootstrap (frame 1) "
          f"{frame_s[1]:.3f} s, frames 2-{window - 1} median "
          f"{float(np.median(frame_s[2:window])):.3f} s, frames {window}-{n - 1} (evicting) "
          f"median {float(np.median(frame_s[window:])):.3f} s, total {sum(frame_s):.3f} s "
          f"({card}); host synchronisations a frame, frames 2-{n - 1} median "
          f"{float(np.median(syncs[2:]))}")
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
    _validated(engine.state, "slice")
    return launches, by_shape


SERVE_ARTIFACT = Path(__file__).resolve().parent / "build" / "chip_smoke_serve.sfm.npz"
SERVE_CHILD_FRAMES = 4


def _served_child(path: str, imgs, device: str, out) -> None:
    """A spawned process: the artifact served over the first frames with the
    Python geometry stack made to raise (``ops.pnp.estimate_pnp`` and the
    frame step). Puts the poses, or the error, on ``out``."""
    try:
        from structure_from_motion_tpu_torch import serve
        from structure_from_motion_tpu_torch.models import incremental
        from structure_from_motion_tpu_torch.ops import pnp

        def refuse(*args, **kwargs):
            raise AssertionError("the served engine entered the Python geometry stack")

        pnp.estimate_pnp = incremental.estimate_pnp = refuse
        incremental._frame_step = incremental._single_step = refuse
        incremental._frame_step_native = refuse
        engine = serve.load_engine(path, seed=0, device=device)
        for im in imgs:
            engine.process_image(im)
        out.put(("ok", engine.poses()[0]))
    except BaseException as e:  # reported to the parent, which fails the phase
        import traceback

        out.put(("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


def serve_phase(dev, imgs, K, C_gt, cfg, counted, sync, card: str) -> dict:
    """The slice's frames through an exported artifact: (a) export a fresh
    engine's programs, (b) live and served engines over every frame,
    taking turns frame by frame, bit for bit (every state field, the
    eviction archive, the reprojection),
    within the slice's bounds, (c) the same launches of B1, B2f, B3 and B4
    and, every frame, the same loop stop-mask reads (the served loops run
    as the live ones: CUDA graph replays), (d) the served 10-iteration
    ``finalize``, bit for bit the live ``finalize(10)``, (e) a spawned
    process serving with the geometry stack made to raise, (f) the times.
    Returns the served run's launch counts (and counts by shape)."""
    import numpy as np
    import torch

    from structure_from_motion_tpu_torch import serve
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM, LazyDraws
    from structure_from_motion_tpu_torch.utils import control

    n = len(imgs)
    span = float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))
    # (a) export
    SERVE_ARTIFACT.parent.mkdir(parents=True, exist_ok=True)
    fresh = IncrementalSfM(cfg, K, frontend="native", seed=0, device=dev)
    fresh.image_shape, fresh.image_dtype = tuple(imgs[0].shape), imgs[0].dtype
    stats: dict = {}
    t0 = time.perf_counter()
    # the native engine's default programs but the precomputed-feature frame
    # step, which this phase does not serve (the CPU tests serve it); its
    # export took ~110 s of the ~280 s here
    sizes = serve.export_engine(fresh, str(SERVE_ARTIFACT), stats=stats,
                                programs=["frame_step_native", "evict", "reproj", "finalize"])
    export_s = time.perf_counter() - t0
    del fresh
    for name in sorted(sizes):
        print(f"serve export {name}: trace {stats[name][0]:.2f} s, save {stats[name][1]:.2f} s, "
              f"{sizes[name]} bytes ({card})")
    print(f"serve export: {export_s:.2f} s in all, artifact {SERVE_ARTIFACT.stat().st_size} bytes "
          f"({card})")
    t0 = time.perf_counter()
    served = serve.load_engine(str(SERVE_ARTIFACT), seed=0, device=dev)
    load_s = time.perf_counter() - t0
    print(f"serve load: {load_s:.2f} s ({card})")

    # (b), (c): the live and the served engine over the frames, taking turns
    # frame by frame (the live one first on even frames), each with its own
    # counts; the last frame of each under torch.profiler (its device time)
    class Run:
        def __init__(self, engine, label):
            self.engine, self.label = engine, label
            self.times, self.syncs, self.reads, self.caps = [], [], [], []
            self.first, self.device_ms, self.capture_s, self.replays = None, None, 0.0, 0
            self.launches = dict.fromkeys(counted, 0)
            self.by_shape = {name: collections.Counter() for name, fn in counted.items()
                             if hasattr(fn, "by_shape")}

        def frame(self, i, im):
            st = control.stats
            before = (st.reads, st.captures, st.capture_s, st.replays, *_read(counted))
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) \
                if i == n - 1 else contextlib.nullcontext()
            with prof:
                with _counting_syncs(self.syncs, dev):
                    t0 = time.perf_counter()
                    self.engine.process_image(im)
                    sync()
                    self.times.append(time.perf_counter() - t0)
            if i == n - 1:
                self.device_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
            self.reads.append(st.reads - before[0])
            self.caps.append(st.captures - before[1])
            self.capture_s += st.capture_s - before[2]
            self.replays += st.replays - before[3]
            launches, by_shape = _read(counted)
            for name in counted:
                self.launches[name] += launches[name] - before[4][name]
            for name in self.by_shape:
                self.by_shape[name].update(by_shape[name])
                self.by_shape[name].subtract(before[5][name])
            if i + 1 == SERVE_CHILD_FRAMES:
                self.first = self.engine.poses()[0]

        def report(self):
            t = self.times
            print(f"serve {self.label}: frame 0 {t[0]:.3f} s, frames 2-{n - 2} median "
                  f"{float(np.median(t[2:-1])):.4f} s, total {sum(t):.3f} s ({card}); host "
                  f"synchronisations a frame, frames 2-{n - 1} median "
                  f"{float(np.median(self.syncs[2:]))}; loop graphs {sum(self.caps)} captures "
                  f"({self.capture_s:.3f} s), {self.replays} replays, {sum(self.reads)} stop-mask "
                  f"reads; stop-mask reads a frame {self.reads}; frame {n - 1} profiled: "
                  f"{t[-1]:.4f} s, device time {self.device_ms:.3f} ms")

    _reset(counted)
    live_run = Run(IncrementalSfM(cfg, K, frontend="native", seed=0, device=dev), "live")
    served_run = Run(served, "served")
    for i, im in enumerate(imgs):
        for r in (live_run, served_run) if i % 2 == 0 else (served_run, live_run):
            r.frame(i, im)
    live_run.report()
    served_run.report()
    live = live_run.engine
    live_t, live_launches, live_first, live_reads, live_dev, live_caps = (
        live_run.times, live_run.launches, live_run.first, live_run.reads, live_run.device_ms,
        live_run.caps)
    served_t, served_launches, served_reads, served_dev, served_caps = (
        served_run.times, served_run.launches, served_run.reads, served_run.device_ms,
        served_run.caps)
    served_by_shape = {name: dict(c) for name, c in served_run.by_shape.items()}
    # no time gate: the host is shared with other machines' work. The live
    # engine's loop graphs exist from the slice phase, the served engine
    # captures its own: only frames in which neither engine captured compare
    frames = [i for i in range(2, n - 1) if not live_caps[i] and not served_caps[i]] \
        or list(range(2, n - 1))
    steady = [float(np.mean([t[i] for i in frames])) for t in (live_t, served_t)]
    extra_ms = 1e3 * (steady[1] - steady[0])
    print(f"serve split: steady served/live {steady[1] / steady[0]:.4f} ({steady[1]:.4f} against "
          f"{steady[0]:.4f} s, the mean of frames {frames}, no graph captured by either; the "
          f"engines in turn); "
          f"the served frame's extra {extra_ms:.3f} ms = "
          f"device {served_dev - live_dev:.3f} ms (profiled frame {n - 1}: live {live_dev:.3f}, "
          f"served {served_dev:.3f} ms) + host {extra_ms - (served_dev - live_dev):.3f} ms ({card})")
    if served_reads != live_reads:
        raise AssertionError(f"served stop-mask reads a frame {served_reads} differ from live "
                             f"{live_reads}")
    fields = type(live.state)._fields
    differ = [f for f, a, b in zip(fields, live.state, served.state) if not torch.equal(a, b)]
    arch = all(np.array_equal(a, b) for ra, rb in zip(live._archive, served._archive)
               for a, b in zip(ra, rb)) \
        and len(live._archive) == len(served._archive) == max(n - cfg.window_size, 0)
    reproj_live, reproj_served = live.reprojection_error(), served.reprojection_error()
    locs, rots = served.poses()
    ate = _umeyama_ate(locs, C_gt) / span
    print(f"serve bits: state fields that differ {differ}, archive equal {arch} "
          f"({len(served._archive)} records), reprojection live {reproj_live!r} served "
          f"{reproj_served!r}; ATE {ate:.5f} of span (bound {ATE_BOUND}), map points "
          f"{len(served.map_points())}")
    kernels_of = ("B1 blur_levels", "B2f candidate_block_max", "B3 match_top2", "B4 ba_blocks",
                  "B7 small_svd")
    print(f"serve launches: live {[live_launches[k] for k in kernels_of]}, served "
          f"{[served_launches[k] for k in kernels_of]} ({', '.join(kernels_of)})")
    if differ or not arch or reproj_live != reproj_served:
        raise AssertionError(f"the served run's bits differ from the live run's: {differ}")
    if not (ate < ATE_BOUND and reproj_served < REPROJ_BOUND_PX and np.isfinite(locs).all()
            and locs.shape == (n, 3)):
        raise AssertionError("the served run is outside the slice's bounds")
    if any(served_launches[k] != live_launches[k] or live_launches[k] < 1 for k in kernels_of):
        raise AssertionError(f"served launches {served_launches} differ from live {live_launches}")

    # (d) the exported finalize against the live one on the equal end states
    costs = served.finalize()
    live_costs = live.finalize(10)
    after = served.reprojection_error()
    differ = [f for f, a, b in zip(fields, live.state, served.state) if not torch.equal(a, b)]
    print(f"serve finalize: costs {costs.shape} {costs[0]:.6g} -> {costs[-1]:.6g}, "
          f"reprojection {reproj_served:.4f} -> {after:.4f} px; against live finalize(10): "
          f"costs equal {np.array_equal(costs, live_costs)}, state fields that differ {differ}")
    if not (costs.shape == (10,) and np.isfinite(costs).all() and after <= reproj_live + 1e-5):
        raise AssertionError("the served finalize failed its bounds")
    if differ or not np.array_equal(costs, live_costs):
        raise AssertionError(f"the served finalize differs from live finalize(10): {differ}")

    # (e) a fresh process that cannot enter the geometry stack
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    t0 = time.perf_counter()
    child = ctx.Process(target=_served_child,
                        args=(str(SERVE_ARTIFACT), imgs[:SERVE_CHILD_FRAMES], str(dev), out))
    child.start()
    try:
        status, result = out.get(timeout=600)
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.kill()
            child.join()
    print(f"serve no-retrace: spawned process {status} in {time.perf_counter() - t0:.1f} s "
          f"(start-up and load included)")
    if status != "ok" or not np.array_equal(result, live_first):
        raise AssertionError(f"the served child failed or differs: {result}")

    # (f) what a frame's draws cost the served engine (all rungs)
    draw_ms = []
    for v in range(2, 7):
        sync()
        t0 = time.perf_counter()
        LazyDraws([0], v, served.state.points.device).materialize(cfg)
        sync()
        draw_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"serve draws a frame: median {float(np.median(draw_ms)):.3f} ms of {draw_ms} ({card})")
    print(f"serve frame time: first live {live_t[0]:.3f} s served {served_t[0]:.3f} s; steady "
          f"mean live {steady[0]:.4f} s served {steady[1]:.4f} s ({card})")
    SERVE_ARTIFACT.unlink()
    return served_launches, served_by_shape


def frame_graph_phase(dev, imgs, K, cfg, graphed_run: dict, sync, card: str) -> None:
    """The slice's frames again with ``utils/control.graphed`` made a plain
    call (every frame's detect + match eager), against the slice phase's
    run (``graphed_run``: frame 0 eager, frame 1 captured, every later
    frame one replay of the CUDA graph): every state field after every
    frame, every statistic and every archive record equal, bit for bit; the
    graph's captures and replays; the host synchronisations a steady frame
    of the graphed run by call site. Raises on a difference."""
    import numpy as np
    import torch

    from structure_from_motion_tpu_torch.models import incremental
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
    from structure_from_motion_tpu_torch.models.tracks import SfMState

    captures, replays = graphed_run["graph"]
    engine = IncrementalSfM(cfg, K, frontend="native", seed=0, device=dev)
    graphed = incremental.graphed
    incremental.graphed = lambda fn, *operands: fn(*operands)
    differ, eager_s = [], []
    try:
        for t, im in enumerate(imgs):
            sync()
            t0 = time.perf_counter()
            info = engine.process_image(im)
            sync()
            eager_s.append(time.perf_counter() - t0)
            want = graphed_run["infos"][t]
            for f, a, b in zip(SfMState._fields, graphed_run["states"][t], engine.state):
                if not torch.equal(a, b):
                    differ.append(f"frame {t} state.{f}")
            for k in want:
                if not np.array_equal(np.asarray(want[k]), np.asarray(info[k])):
                    differ.append(f"frame {t} info[{k!r}]")
    finally:
        incremental.graphed = graphed
    records = list(engine._archive)
    if len(records) != len(graphed_run["archive"]) or not records:
        differ.append(f"archive of {len(records)} records against {len(graphed_run['archive'])}")
    for i, (a, b) in enumerate(zip(graphed_run["archive"], records)):
        differ += [f"archive[{i}].{f}" for f, x, y in zip(a._fields, a, b)
                   if not np.array_equal(x, y)]
    n = len(imgs)
    steady = [t for t in range(2, n) if t != cfg.window_size]
    print(f"frame graph: detect + match of {n} slice frames ({n - cfg.window_size} evicting), "
          f"{captures} capture and {replays} replays of the frame graph, against every frame "
          f"eager: state fields, statistics and {len(records)} archive records that differ "
          f"{differ[:8] or 'none'}; eager frames 2-{n - 1} median "
          f"{float(np.median(eager_s[2:])):.4f} s ({card})")
    sites = graphed_run["sites"]
    t = LOOP_FRAME
    print(f"frame graph: host synchronisations a frame {graphed_run['syncs']}; frame {t} "
          f"(steady) by site {sites[t]}; frame {n - 1} (slide, evicts) by site {sites[n - 1]} "
          f"({card})")
    if differ:
        raise AssertionError(f"graphed frames differ from eager ones: {differ[:8]}")
    if captures != 1 or replays < n - 2:
        raise AssertionError(f"the frame graph was captured {captures} times and replayed "
                             f"{replays} times in {n} frames (want 1 and {n - 2})")


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
    print(f"global launches: {launches}; {_loop_stats()}")
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
    return launches, dict(costs=costs, locs=locs, rots=rots, wall=wall, cg=cg)


def _loop_site(call) -> str:
    """A loop call's site: the step's module, its cap and its constants."""
    n, _, step, _, operands, _ = call
    fn = step.func
    consts = "".join(f", {name} {v}" for name, v in step.keywords.items() if not callable(v))
    huber = ", Huber" if fn.__module__.endswith(".pnp") and operands[-1] is not None else ""
    return f"{fn.__module__.rsplit('.', 1)[-1]} (n {n}{consts}{huber})"


def loops_phase(dev, loops: LoopRecorder, single_global: dict, sync, card: str) -> None:
    """Phase 12: every recorded loop call through the graph path against the
    plain per-step loop, bit for bit, with its steps; the 500-camera solve
    with the plain PCG loop against phase 5's (CG counts, costs and poses
    equal); the graph numbers and host synchronisations a frame. Raises on
    a difference."""
    import numpy as np
    import torch

    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
    from structure_from_motion_tpu_torch.ops import linalg, pnp
    from structure_from_motion_tpu_torch.utils import control

    control.reset_stats()
    differ = []
    for run, calls in loops.calls.items():
        sites: dict = {}
        for call in calls:
            n, k, step, carried, operands, capture = call
            got = control.masked_loop(n, k, step, carried, *operands, capture=capture)
            steps = [0]

            def counted(*args, step=step):
                steps[0] += 1
                return step(*args)

            want = control.masked_loop_reference(n, k, counted, carried, *operands)
            site = _loop_site(call)
            sites.setdefault(site, []).append(steps[0])
            # the state, not the mask: at the cap the plain loop stops with
            # problems still active, where the masked steps have cleared them
            if not all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])):
                differ.append(f"{run}: {site}")
        for site, steps in sites.items():
            print(f"loops {run}: {site}: {len(steps)} calls, steps of the plain loop {steps}")
        if not calls:
            raise AssertionError(f"no loop call was recorded in the {run} run")
    print(f"loops graph against plain: {sum(map(len, loops.calls.values()))} calls, bits "
          f"differ in {differ or 'none'}")
    if differ:
        raise AssertionError(f"the graph path's bits differ from the plain loop's: {differ}")

    # the 500-camera solve with the plain PCG loop against phase 5's
    engine = IncrementalSfM(long_sequence_config(), np.eye(3), frontend="precomputed", device=dev)
    engine.load_checkpoint(str(ARTIFACT))
    linalg.masked_loop = control.masked_loop_reference
    try:
        sync()
        t0 = time.perf_counter()
        info = engine.finalize_global(iterations=20)
        sync()
        wall = time.perf_counter() - t0
    finally:
        linalg.masked_loop = control.masked_loop
    locs, rots = engine.poses()
    costs = [float(c) for c in info["costs"]]
    same = (list(info["cg_iterations"]) == single_global["cg"] and costs == single_global["costs"]
            and np.array_equal(locs, single_global["locs"])
            and np.array_equal(rots, single_global["rots"]))
    print(f"loops global: plain PCG loop {wall:.3f} s against the graphs' "
          f"{single_global['wall']:.3f} s (phase 5) ({card}); CG iterations {info['cg_iterations']}, final cost "
          f"{costs[-1]!r}; counts, costs and poses equal to phase 5's: {same}")
    if not same:
        raise AssertionError("the plain PCG loop's solve differs from the graph path's")
    syncs = {run: float(np.median(v[2:])) for run, v in loops.syncs.items()}
    print(f"loops: k {pnp.LM_CHUNK} LM steps, {linalg.CG_CHUNK} CG iterations a chunk; "
          f"{len(control._GRAPHS)} graphs held; this phase's {_loop_stats()}; host "
          f"synchronisations a steady frame (median) {syncs} ({card})")


def _cpu_args(args) -> tuple:
    return tuple(a.detach().cpu() if hasattr(a, "detach") else a for a in args)


def _poses_digest(locs, rots) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(locs).tobytes()
                          + np.ascontiguousarray(rots).tobytes()).hexdigest()


def _sharded_rank(rank: int, port: int, work: str, device: str) -> None:
    """One rank of the sharded phase (started by :func:`sharded_phase`): a
    gloo group of ``SHARDS`` ranks over CUDA tensors of the one card (NCCL
    refuses two ranks on one GPU). (a) ``finalize_global(20,
    num_shards=SHARDS)`` on the 500-camera checkpoint, (b)
    ``IncrementalSfM(ba_num_shards=SHARDS)`` on the rendered frames in
    ``work``; each with the kernels' launch counts set to 0 just before and
    read just after, and rank 0's last B4, B5 and B6 inputs saved for the
    kernel phase. Writes ``rank<r>.pt`` to ``work``."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from structure_from_motion_tpu_torch.config import PipelineConfig
    from structure_from_motion_tpu_torch.models import incremental
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
    from structure_from_motion_tpu_torch.ops import ba as ba_module
    from structure_from_motion_tpu_torch.ops import ba_cuda, ba_matvec, blur_cuda
    from structure_from_motion_tpu_torch.ops import features_cuda, matching

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=SHARDS,
                            rank=rank)
    work_dir = Path(work)
    counted = {"B1 blur_levels": blur_cuda.blur_levels,
               "B2f candidate_block_max": features_cuda.candidate_block_max,
               "B2 candidate_response": features_cuda.candidate_response,
               "B3 match_top2": matching.match_top2, "B4 ba_blocks": ba_cuda.ba_blocks,
               "B5 expand_cam": ba_matvec.expand_cam, "B6 reduce_cam": ba_matvec.reduce_cam}
    sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
    res = {}
    try:
        # (a) the whole-trajectory solve, sharded
        engine = IncrementalSfM(long_sequence_config(), np.eye(3), frontend="precomputed",
                                device=device)
        engine.load_checkpoint(str(ARTIFACT))
        sync()
        _reset(counted)
        t0 = time.perf_counter()
        with last_call(ba_module, "ba_blocks") as b4, last_call(ba_module, "expand_cam") as b5, \
                last_call(ba_module, "reduce_cam") as b6:
            info = engine.finalize_global(iterations=20, num_shards=SHARDS)
            sync()
        wall = time.perf_counter() - t0
        locs, rots = engine.poses()
        res["global"] = dict(
            launches=_read(counted)[0], wall=wall, costs=[float(c) for c in info["costs"]],
            cg=list(info["cg_iterations"]), slots=info["slots"], tail=info["tail"],
            rows=info["tiers"][0][1], bucket=info["bucket"], locs=locs, rots=rots,
            digest=_poses_digest(locs, rots))
        if rank == 0:
            torch.save({"b4": _cpu_args(b4["args"]), "b5": _cpu_args(b5["args"]),
                        "b6": _cpu_args(b6["args"])}, work_dir / "global_inputs.pt")
        del engine

        # (b) the per-frame BA sharded, every rank on the same frames; each
        # rank's own state as it reaches the sharded BA, field by field (the
        # stage first takes rank 0's)
        pre_ba = []
        sharded_ba = incremental._sharded_ba

        def spy(st, config):
            pre_ba.append({k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
                           for k, v in st._asdict().items()})
            return sharded_ba(st, config)

        incremental._sharded_ba = spy
        frames = np.load(work_dir / "frames.npz")
        cfg = PipelineConfig.from_json((work_dir / "config.json").read_text())
        cfg = dataclasses.replace(cfg, ba_num_shards=SHARDS)
        engine = IncrementalSfM(cfg, frames["K"], frontend="native", seed=0, device=device)
        sync()
        _reset(counted)
        times = []
        with last_call(ba_module, "ba_blocks") as b4:
            for im in frames["imgs"]:
                t0 = time.perf_counter()
                info = engine.process_image(im)
                sync()
                times.append(time.perf_counter() - t0)
        locs, rots = engine.poses()
        incremental._sharded_ba = sharded_ba
        res["frames"] = dict(launches=_read(counted)[0], times=times, locs=locs, rots=rots,
                             digest=_poses_digest(locs, rots), pre_ba=pre_ba,
                             reproj=engine.reprojection_error(),
                             dropped=int(info["ba_dropped_obs"]))
        if rank == 0:
            torch.save({"b4": _cpu_args(b4["args"])}, work_dir / "frame_inputs.pt")
    finally:
        dist.destroy_process_group()
    torch.save(res, work_dir / f"rank{rank}.pt")


def sharded_phase(dev, imgs, K, C_gt, cfg, single_global: dict, card: str):
    """The sharded bundle adjustment: ``SHARDS`` gloo ranks on this one card
    (:func:`_sharded_rank`) run (a) the sharded 500-camera solve and (b) the
    per-frame sharded engine on ``imgs``; held to the global limits and to
    ``single_global`` (the single-device solve of this smoke), to the
    single engine on the same frames, and every rank to the same camera
    bits. Then a one-rank NCCL group through ``sharded_bundle_adjustment``
    with S = 1 (the hybrid layout of the same problem). Two ranks on one
    card share its SMs: their times are no multi-GPU speed. Returns the
    launch counts of (a) and (b), summed over the ranks, under "sharded
    global" and "sharded frames", and rank 0's saved kernel inputs."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from structure_from_motion_tpu_torch.models import global_ba
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
    from structure_from_motion_tpu_torch.parallel import make_mesh
    from structure_from_motion_tpu_torch.utils import checkpoint

    device = str(dev)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_sharded"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    np.savez(work / "frames.npz", imgs=np.stack([np.asarray(im) for im in imgs]), K=K)
    (work / "config.json").write_text(cfg.to_json())
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    ctx = tmp.start_processes(_sharded_rank, args=(port, str(work), device), nprocs=SHARDS,
                              join=False, start_method="spawn")
    # meanwhile the single engine on the same frames, the reference of (b)
    single = IncrementalSfM(cfg, K, frontend="native", seed=0, device=dev)
    for im in imgs:
        single.process_image(im)
    s_locs, s_rots = single.poses()
    while not ctx.join(timeout=1200):
        pass
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(SHARDS)]
    print(f"sharded: {SHARDS} gloo ranks on one card, {time.perf_counter() - t0:.1f} s from "
          "spawn to join (start-up included)")

    def summed(run):
        return {k: sum(r[run]["launches"][k] for r in ranks) for k in ranks[0][run]["launches"]}

    # (a) the sharded whole-trajectory solve
    g = ranks[0]["global"]
    costs, single_costs = g["costs"], single_global["costs"]
    same = all(r["global"]["digest"] == g["digest"] for r in ranks)
    rel = abs(costs[-1] - single_costs[-1]) / single_costs[-1]
    # the poses after similarity alignment (the gauge is free: the two solves
    # may drift along it differently in f32)
    g_span = float(np.linalg.norm(single_global["locs"].max(0) - single_global["locs"].min(0)))
    d_ate = _umeyama_ate(g["locs"], single_global["locs"]) / g_span
    dC = float(np.abs(g["locs"] - single_global["locs"]).max())
    dR = float(np.abs(g["rots"] - single_global["rots"]).max())
    launches_g = summed("global")
    print(f"sharded global: S = {SHARDS}, ELL rows {g['rows']}, tail {g['tail']}, {g['slots']} "
          f"slots a shard (bucket {g['bucket']}); CG iterations per LM step {g['cg']} (single "
          f"device: {single_global['cg']}); wall {[round(r['global']['wall'], 3) for r in ranks]} s a rank "
          f"({card}; two ranks share one card: no multi-GPU speed)")
    print(f"sharded global costs: {[round(c, 6) for c in costs]}")
    print(f"sharded global quality: final cost {costs[-1]:.6f} (bound 1.05 x {JAX_GLOBAL_COST}), "
          f"final / first {costs[-1] / costs[0]:.4f} (bound 0.3); against the single-device "
          f"solve's {single_costs[-1]:.6f}: relative {rel:.2e} (bound 2e-2), aligned camera "
          f"centres {d_ate:.2e} of span (bound 1e-3; raw max |dC| {dC:.2e}, |dR| {dR:.2e}); "
          f"every rank's poses the same bits: {same}; launches (both ranks) {launches_g}")
    if not (costs[-1] <= 1.05 * JAX_GLOBAL_COST and costs[-1] <= 0.3 * costs[0]):
        raise AssertionError("the sharded global cost is outside its bounds")
    if not (same and rel <= 2e-2 and d_ate <= 1e-3):
        raise AssertionError("the sharded global solve disagrees with the single-device one "
                             "or between its ranks")
    for name in ("B4 ba_blocks", "B5 expand_cam", "B6 reduce_cam"):
        if any(r["global"]["launches"][name] < 1 for r in ranks):
            raise AssertionError(f"{name} never launched in a rank of the sharded global solve")

    # (b) the per-frame sharded engine
    f = ranks[0]["frames"]
    same = all(r["frames"]["digest"] == f["digest"] for r in ranks)
    span = float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))
    ate, s_ate = _umeyama_ate(f["locs"], C_gt) / span, _umeyama_ate(s_locs, C_gt) / span
    dl, dr = float(np.abs(f["locs"] - s_locs).max()), float(np.abs(f["rots"] - s_rots).max())
    launches_f = summed("frames")
    # diagnostic: where the ranks' own states had drifted apart before a BA
    # (the engine's bits on the card need not repeat between processes)
    drift = [(i, sorted(k for k in d if d[k] != d1[k]))
             for i, (d, d1) in enumerate(zip(f["pre_ba"], ranks[1]["frames"]["pre_ba"]))]
    print(f"sharded frames: the ranks' own states before each sharded BA (frames 2-"
          f"{len(imgs) - 1}), the fields that differ: {drift}")
    print(f"sharded frames ({len(imgs)} frames, ba_num_shards = {SHARDS}): frame times rank 0 "
          f"{np.round(f['times'], 3).tolist()} s ({card}; two ranks share one card); ATE "
          f"{ate:.5f} of span (single engine {s_ate:.5f}; bound {ATE_BOUND}), reprojection "
          f"{f['reproj']:.4f} px (single {single.reprojection_error():.4f}; bound "
          f"{REPROJ_BOUND_PX}); against the single engine max |dC| {dl:.2e}, max |dR| {dr:.2e} "
          f"(atol 5e-3); every rank's poses the same bits: {same}; observations dropped by a "
          f"full bucket {f['dropped']}; launches (both ranks) {launches_f}")
    if not (same and dl <= 5e-3 and dr <= 5e-3 and f["dropped"] == 0):
        raise AssertionError("the per-frame sharded run disagrees with the single engine or "
                             "between its ranks")
    if not (ate < ATE_BOUND and s_ate < ATE_BOUND and f["reproj"] < REPROJ_BOUND_PX
            and single.reprojection_error() < REPROJ_BOUND_PX):
        raise AssertionError("a per-frame sharded or single run is outside the slice's bounds")
    for name in ("B1 blur_levels", "B2f candidate_block_max", "B3 match_top2", "B4 ba_blocks"):
        if any(r["frames"]["launches"][name] < 1 for r in ranks):
            raise AssertionError(f"{name} never launched in a rank of the per-frame sharded run")
    del single

    # a one-rank NCCL group: the sharded solve (hybrid layout, S = 1) of the
    # same problem, its sums through NCCL
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"  # gloo: a CPU rehearsal
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        state, frame, archive, _ = checkpoint.load_state(str(ARTIFACT), dev)
        prob = global_ba.build_global_problem(state, archive, min(frame, 8))
        stats: dict = {}
        t0 = time.perf_counter()
        out, ncosts = global_ba.solve_sharded(prob, long_sequence_config().ba, mesh, 20, stats)
        if backend == "nccl":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    rel1 = abs(float(ncosts[-1]) - single_costs[-1]) / single_costs[-1]
    print(f"sharded NCCL, one rank (group {mesh.group is not None}, backend {backend}): hybrid ELL "
          f"rows {stats['tiers'][0][1]}, tail {stats['tail']}, {stats['slots']} slots; CG "
          f"iterations {stats['cg_iterations']}; cost {float(ncosts[0]):.6f} -> "
          f"{float(ncosts[-1]):.6f}, relative to the single-device solve {rel1:.2e} (bound "
          f"2e-2); {wall:.3f} s ({card})")
    if not (mesh.group is not None and rel1 <= 2e-2 and float(ncosts[-1]) <= 1.05 * JAX_GLOBAL_COST):
        raise AssertionError("the one-rank NCCL solve disagrees with the single-device solve")
    inputs = dict(torch.load(work / "global_inputs.pt", weights_only=False),
                  frame_b4=torch.load(work / "frame_inputs.pt", weights_only=False)["b4"])
    shutil.rmtree(work)
    return {"sharded global": (launches_g, {}), "sharded frames": (launches_f, {})}, inputs


def kernel_phase(dev, imgs, small_img, cfg, smi: str, lane_imgs, map_lane_imgs,
                 small_lane_imgs, harris_img, harris_fe, small_b4, harris_b4, shard_in) -> list:
    """Every kernel against its plain version on the card at the shapes its
    path gives it, and the lane axis of B1-B4 at the batched phases' shapes
    (``lane_imgs``: frame 0 of every full-width lane; ``map_lane_imgs``: of
    every lane of the map run; ``small_lane_imgs``: of every lane of the
    small batch, whose last B4 inputs are ``small_b4``), and B1 and B4 at
    the Harris run's shapes (``harris_img``: its frame 0, ``harris_fe``: its
    frontend config; ``harris_b4``: its last B4 inputs), and B4, B5 and B6 at the
    sharded runs' shapes (``shard_in``: rank 0's last inputs of each, from
    :func:`sharded_phase`); raises on a disagreement. Returns the kernels' entries
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
        _b4_kernels(torch, lambda: ba_cuda.ba_blocks(*bargs), smi, name, results[-1]["bound_ms"])
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
    del state, prob, st, obs, bargs, got, w21, t, t_ref, y, perm, mask
    torch.cuda.empty_cache()

    # B4, B5 and B6 at the sharded runs' shapes, on rank 0's own last inputs:
    # a shard of the global solve (its hybrid ELL and spill tail) and a shard
    # of the per-frame BA ((M/S) x V slots); launches of both ranks
    def on_card(args):
        return tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)

    sb4 = on_card(shard_in["b4"])
    b4_case(f"B4 ba_blocks (sharded global, a shard's hybrid ELL + tail, O = "
            f"{sb4[0].shape[0]}, V = {sb4[6]})", sb4, "sharded global")
    fb4 = on_card(shard_in["frame_b4"])
    b4_case(f"B4 ba_blocks (sharded frames, a shard, O = {fb4[0].shape[0]}, V = {fb4[6]})", fb4,
            "sharded frames")
    # These inputs are the last CG direction of a sharded solve, whose size
    # differs from run to run by orders of magnitude (the tail sums in no
    # fixed order; tools/sharded_matvec_inputs.py prints the spread) and
    # whose products cancel when it is large: each sum is held, entry by
    # entry, to its conditioning (the sum of the products' magnitudes, a
    # sum's forward error bound), and both sums' distances to the float64
    # one are printed.
    scam, sw21, sx = on_card(shard_in["b5"])
    t, t_ref = ba_matvec.expand_cam(scam, sw21, sx), ba_matvec.expand_cam_reference(scam, sw21, sx)
    t64 = ba_matvec.expand_cam_reference(scam, sw21.double(), sx.double())
    mag = ba_matvec.expand_cam_reference(scam, sw21.abs().double(), sx.abs().double())
    err = float((t - t_ref).abs().max())
    ok = bool(((t - t_ref).abs() <= 1e-5 * mag.clamp_min(1.0)).all())
    record(f"B5 expand_cam (sharded global, a shard, O = {scam.shape[0]})", "ba_matvec.cu",
           "structure_from_motion_tpu/ops/ba_matvec_pallas.py:91", err,
           f"1e-5 x max(1, sum |W||x|) entry by entry, max |t| {float(t_ref.abs().max()):.3e}, "
           f"max sum |W||x| {float(mag.max()):.3e}, max |x| {float(sx.abs().max()):.3e}; to "
           f"float64: kernel {float((t - t64).abs().max()):.3e}, plain "
           f"{float((t_ref - t64).abs().max()):.3e}",
           lambda: ba_matvec.expand_cam(scam, sw21, sx),
           lambda: ba_matvec.expand_cam_reference(scam, sw21, sx), ok,
           moved=nbytes(scam, sw21, sx, t), flops=2 * 21 * scam.shape[0], path="sharded global")
    rw21, ry, rperm, rmask, rV = on_card(shard_in["b6"])
    c1 = ba_matvec.reduce_cam(rw21, ry, rperm, rmask, rV)
    c2 = ba_matvec.reduce_cam(rw21, ry, rperm, rmask, rV)
    c_ref = ba_matvec.reduce_cam_reference(rw21, ry, rperm, rmask, rV)
    c64 = ba_matvec.reduce_cam_reference(rw21.double(), ry.double(), rperm, rmask, rV)
    cmag = ba_matvec.reduce_cam_reference(rw21.abs().double(), ry.abs().double(), rperm, rmask,
                                          rV)
    err = float((c1 - c_ref).abs().max())
    ok = bool(((c1 - c_ref).abs() <= 1e-4 * cmag.clamp_min(1.0)).all())
    n_filled = int(rmask.sum())
    record(f"B6 reduce_cam (sharded global, a shard, {rV} cameras x {rperm.shape[0] // rV} slots, "
           f"{n_filled} filled)", "ba_matvec.cu",
           "structure_from_motion_tpu/ops/ba_matvec_pallas.py:125", err,
           f"1e-4 x max(1, sum |W||y|) entry by entry, max |coup| "
           f"{float(c_ref.abs().max()):.3e}, max sum |W||y| {float(cmag.max()):.3e}; to float64: "
           f"kernel {float((c1 - c64).abs().max()):.3e}, plain "
           f"{float((c_ref - c64).abs().max()):.3e}; two launches same bits: {torch.equal(c1, c2)}",
           lambda: ba_matvec.reduce_cam(rw21, ry, rperm, rmask, rV),
           lambda: ba_matvec.reduce_cam_reference(rw21, ry, rperm, rmask, rV),
           ok and torch.equal(c1, c2),
           moved=n_filled * (84 + 12) + nbytes(rperm, rmask, c1), flops=2 * 21 * n_filled,
           path="sharded global")
    del sb4, fb4, scam, sw21, sx, t, t_ref, t64, mag, rw21, ry, rperm, rmask, c1, c2, c_ref
    del c64, cmag
    torch.cuda.empty_cache()

    # -- the lane axis: B lanes in one launch, at the batched phases' shapes
    B = len(lane_imgs)

    def lane_checks(label, fn, lanes_in, one_in):
        """(lane b equals a one-lane launch on lane b's inputs, for every b;
        a one-lane stack equals the call without a lane axis), bit for bit.
        ``fn`` returns a tuple of tensors; ``lanes_in`` / ``one_in`` slice
        its inputs to lane b / to lane b without the lane axis."""
        got = fn(*lanes_in(slice(None)))
        n = got[0].shape[0]
        lanes_same = all(
            all(torch.equal(g[b], o) for g, o in zip(got, fn(*one_in(b)))) for b in range(n))
        first = fn(*lanes_in(slice(0, 1)))
        one_same = all(torch.equal(f[0], o) for f, o in zip(first, fn(*one_in(0))))
        print(f"kernel {label}: lane b equals its one-lane launch, bit for bit, for every b: "
              f"{lanes_same}; a one-lane stack equals the call without a lane axis: {one_same}")
        return got, lanes_same and one_same

    def lane_img(im):
        t = torch.as_tensor(im).to(dev).to(torch.float32)
        return t / t.max()

    def b1_lanes(label, src, ks, path):
        n, h, w = src.shape
        got, bits = lane_checks(
            f"B1 blur_levels lanes{label}",
            lambda x: (blur_cuda.blur_levels(x.contiguous(), ks),),
            lambda sl: (src[sl],), lambda b: (src[b],))
        ref = blur_cuda.blur_levels_reference(src, ks)
        err = float((got[0] - ref).abs().max())
        record(f"B1 blur_levels lanes{label}", "blur.cu",
               "structure_from_motion_tpu/ops/blur_pallas.py:85", err,
               f"atol 2e-5; {n} lanes of {h}x{w}, radii {[len(k) // 2 for k in ks]}; lanes "
               f"bit for bit as one-lane launches: {bits}",
               lambda: blur_cuda.blur_levels(src, ks),
               lambda: blur_cuda.blur_levels_reference(src, ks), err <= 2e-5 and bits,
               moved=nbytes(src, got[0]),
               flops=sum(2 * 2 * len(k) for k in ks) * src.numel(),
               shape=(n, h, w, len(ks)), path=path)
        return got[0]

    def pyramid_lanes(stack, path, fe=fe, tag=""):
        """B1 and the B2 kernel of each octave at every shape of a (B, H, W)
        frame stack, as the frontend ``fe`` launches them: the fused B2
        where its 8x8 blocks tile the octave, else the map kernel."""
        if fe.upsample_first_octave:
            src, ks = features._upsample2x(stack).contiguous(), base_k
        else:
            src, ks = stack, [features._gaussian_kernel1d(fe.sigma0)]
        base = b1_lanes(f" ({tag}base blur, {src.shape[1]}x{src.shape[2]}, 1 level)", src, ks,
                        path)[:, 0]
        for _ in range(fe.num_octaves):
            h, w = base.shape[-2:]
            gauss = torch.cat([base[:, None], b1_lanes(f" ({tag}{h}x{w})", base, rel, path)],
                              dim=1)
            dog = (gauss[:, 1:] - gauss[:, :-1]).contiguous()
            fused = fe.topk_block == 8 and h % 8 == 0 and w % 8 == 0
            (b2f_lanes if fused else b2_map_lanes)(dog, h, w, path, tag)
            base = features._downsample2(gauss[:, S])

    def b2f_lanes(dog, h, w, path, tag):
        got, bits = lane_checks(
            f"B2f candidate_block_max lanes ({tag}{h}x{w})",
            lambda d: features_cuda.candidate_block_max(d.contiguous(), *args),
            lambda sl: (dog[sl],), lambda b: (dog[b],))
        ref = features_cuda.candidate_block_max_reference(dog, *args)
        same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        record(f"B2f candidate_block_max lanes ({tag}{h}x{w})", "cand.cu", cand_src,
               float((got[0] - ref[0]).abs().max()),
               f"atol 0 (cand and pos equal: {same}); {tuple(dog.shape)}; lanes bit for bit as "
               f"one-lane launches: {bits}",
               lambda: features_cuda.candidate_block_max(dog, *args),
               lambda: features_cuda.candidate_block_max_reference(dog, *args), same and bits,
               moved=nbytes(dog, *got), flops=40 * dog.shape[0] * (dog.shape[1] - 2) * h * w,
               shape=(dog.shape[0], h, w), path=path)

    def b2_map_lanes(dog, h, w, path, tag):
        got, bits = lane_checks(
            f"B2 candidate_response lanes ({tag}{h}x{w})",
            lambda d: (features_cuda.candidate_response(d.contiguous(), *args),),
            lambda sl: (dog[sl],), lambda b: (dog[b],))
        ref = features_cuda.candidate_response_reference(dog, *args)
        err = float((got[0] - ref).abs().max())
        record(f"B2 candidate_response lanes ({tag}{h}x{w})", "cand.cu", cand_src, err,
               f"atol 0 (exact); {tuple(dog.shape)}, {int((ref > 0).sum())} candidates; lanes "
               f"bit for bit as one-lane launches: {bits}",
               lambda: features_cuda.candidate_response(dog, *args),
               lambda: features_cuda.candidate_response_reference(dog, *args),
               err == 0.0 and bits, moved=nbytes(dog, got[0]), flops=40 * got[0].numel(),
               shape=(dog.shape[0], h, w), path=path)

    pyramid_lanes(torch.stack([lane_img(im) for im in lane_imgs]), "batched")
    torch.cuda.empty_cache()
    pyramid_lanes(torch.stack([lane_img(im) for im in map_lane_imgs]), "batched map",
                  dataclasses.replace(fe, topk_block=0))
    torch.cuda.empty_cache()
    # the small batch: bench.py's small config (no 2x octave: the base blur
    # takes sigma0 whole; 8 does not divide its last octave, 60x80)
    pyramid_lanes(torch.stack([lane_img(im) for im in small_lane_imgs]), "small batch",
                  small_batch_config().frontend, "small batch, ")

    def b3_lanes(label, nr, nq, path):
        """Each lane's ``nr`` reference rows against its own ``nq`` queries."""
        lref = torch.stack([descriptors(nr) for _ in range(B)])
        lque = torch.stack([descriptors(nq) for _ in range(B)])
        lmask = torch.as_tensor(rng.random((B, nq)) < 0.9).to(dev)
        got, bits = lane_checks(f"B3 match_top2 lanes{label}", matching.match_top2,
                                lambda sl: (lref[sl], lque[sl], lmask[sl]),
                                lambda b: (lref[b], lque[b], lmask[b]))
        r1, r2, rj = matching.match_top2_reference(lref, lque, lmask)
        err = float(max((got[0] - r1).abs().max(), (got[1] - r2).abs().max()))
        close = all(bool(((a - b).abs() <= 1e-4 + 1e-5 * b.abs()).all())
                    for a, b in ((got[0], r1), (got[1], r2)))
        same_j = bool((got[2] == rj)[(r2 - r1) > 1e-3].all())
        record(f"B3 match_top2 lanes{label}", "match_top2.cu",
               "structure_from_motion_tpu/ops/matching.py:220",
               err, f"d^2 rtol 1e-5 atol 1e-4, j1 equal where d2^2-d1^2 > 1e-3; {B} lanes of "
               f"{tuple(lref.shape[1:])} x {tuple(lque.shape[1:])}; lanes bit for bit as one-lane "
               f"launches: {bits}",
               lambda: matching.match_top2(lref, lque, lmask),
               lambda: matching.match_top2_reference(lref, lque, lmask),
               close and same_j and bits,
               moved=nbytes(lref, lque, lmask) + 12 * B * lref.shape[1],
               flops=3 * 2 * lref.shape[1] * int(lmask.sum()) * 128, flop_rate=PEAK_TF32_FLOPS,
               path=path)
        torch.cuda.empty_cache()

    # B3: each lane's V views x K rows against its own K queries
    cap, scap = cfg.capacity, small_batch_config().capacity
    b3_lanes("", cap.max_views * cap.max_keypoints, cap.max_keypoints, "batched")
    b3_lanes(" (small batch)", scap.max_views * scap.max_keypoints, scap.max_keypoints,
             "small batch")

    def b4_lanes(label, largs, path):
        V = largs[6]
        got, bits = lane_checks(f"B4 ba_blocks lanes{label}",
                                lambda *a: ba_cuda.ba_blocks(*a, *largs[6:]),
                                lambda sl: tuple(a[sl] for a in largs[:6]),
                                lambda b: tuple(a[b] for a in largs[:6]))
        ref = ba_cuda.ba_blocks_reference(*largs)
        errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        scaled = [e / max(1.0, float(b.abs().max())) for e, b in zip(errs, ref)]
        record(f"B4 ba_blocks lanes{label}", "ba_blocks.cu",
               "structure_from_motion_tpu/ops/ba_pallas.py:163",
               max(errs), f"1e-3 x max(1, |value|); worst scaled {max(scaled):.2e}; "
               f"{largs[0].shape[0]} lanes of O = {largs[0].shape[1]}, V = {V}; lanes bit for "
               f"bit as one-lane launches: {bits}",
               lambda: ba_cuda.ba_blocks(*largs), lambda: ba_cuda.ba_blocks_reference(*largs),
               max(scaled) <= 1e-3 and bits,
               moved=nbytes(*largs[:6], *got[2:5]) + 4 * 57 * V * largs[0].shape[0],
               flops=400 * largs[0].numel(), path=path)
        _b4_kernels(torch, lambda: ba_cuda.ba_blocks(*largs), smi, f"B4 ba_blocks lanes{label}",
                    results[-1]["bound_ms"])
        torch.cuda.empty_cache()

    # B4: each lane's full ELL stream, 16384 points x 16 slots, V = 16; and
    # the small batch's last BA stream as its path gave it
    per_lane = [b4_random(16384 * 16, 16) for _ in range(B)]
    b4_lanes("", tuple(torch.stack([a[i] for a in per_lane]) for i in range(6)) + (16, 0.01),
             "batched")
    del per_lane
    b4_lanes(" (small batch, its last BA stream)", small_b4, "small batch")

    # -- the Harris run's shapes: per octave the one-level blurs at sigma
    # 1.0 (the octave's image) and 2.0 (what BRIEF reads), the three
    # structure-tensor products as three lanes of one sigma 1.5 blur; the
    # last octave's sigma 1.0 blur alone; then its last BA stream
    def gk(sigma):
        return [features._gaussian_kernel1d(sigma)]

    def b1_pair(h, w, pairs):
        """The one-level B1 launches the Harris path makes at (h, w): a
        list of (input, sigma), one launch each."""
        got = [blur_cuda.blur_levels(x, gk(sg)) for x, sg in pairs]
        ref = [blur_cuda.blur_levels_reference(x, gk(sg)) for x, sg in pairs]
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        sigmas = " and ".join(f"{sg}" for _, sg in pairs)
        record(f"B1 blur_levels (harris, {h}x{w}, 1 level at sigma {sigmas}, "
               f"{len(pairs)} launch{'es' if len(pairs) > 1 else ''})", "blur.cu",
               "structure_from_motion_tpu/ops/blur_pallas.py:85", err,
               f"atol 2e-5; radii {[len(gk(sg)[0]) // 2 for _, sg in pairs]}",
               lambda: [blur_cuda.blur_levels(x, gk(sg)) for x, sg in pairs],
               lambda: [blur_cuda.blur_levels_reference(x, gk(sg)) for x, sg in pairs],
               err <= 2e-5, moved=sum(nbytes(x, g) for (x, _), g in zip(pairs, got)),
               flops=sum(2 * 2 * len(gk(sg)[0]) * x.numel() for x, sg in pairs),
               shape=(h, w, 1), path="harris")
        return got

    himg = lane_img(harris_img)
    level_in = himg
    for _ in range(harris_fe.num_octaves):
        h, w = level_in.shape
        level = blur_cuda.blur_levels(level_in, gk(1.0))[0]
        b1_pair(h, w, [(level_in, 1.0), (level, 2.0)])
        ix = 0.5 * (torch.roll(level, -1, -1) - torch.roll(level, 1, -1))
        iy = 0.5 * (torch.roll(level, -1, -2) - torch.roll(level, 1, -2))
        prods = torch.stack([ix * ix, iy * iy, ix * iy]).contiguous()
        b1_lanes(f" (harris, 3 structure-tensor lanes of {h}x{w}, sigma 1.5)", prods, gk(1.5),
                 "harris")
        level_in = features._downsample2(level).contiguous()
    b1_pair(*level_in.shape, [(level_in, 1.0)])
    b4_case(f"B4 ba_blocks (harris, its last BA stream, O = {harris_b4[0].shape[0]})",
            harris_b4, "harris")
    return results


def _gram_nullspace(A):
    """The null vector of the JAX package's accelerator path
    (``structure_from_motion_tpu/ops/linalg.py:57``): shifted inverse
    iteration on the f32 gram matrix, here in torch, as the yardstick that
    the 6-point PnP margin is held against."""
    import torch

    n = A.shape[-1]
    G = A.transpose(-1, -2) @ A
    eps = (1e-5 * G.diagonal(dim1=-2, dim2=-1).sum(-1) + 1e-30)[..., None, None]
    Gd = G + eps * torch.eye(n, dtype=A.dtype, device=A.device)
    Ginv = torch.cholesky_inverse(torch.linalg.cholesky(Gd))
    x = torch.take_along_dim(Ginv, Ginv.norm(dim=-2).argmax(-1)[..., None, None], dim=-1)[..., 0]
    for _ in range(6):
        x = torch.linalg.solve(Gd, x[..., None])[..., 0]
        x = x / x.norm(dim=-1, keepdim=True)
    return x


def _b7_check(torch, S, A, full: bool):
    """Kernel B7 on ``A`` against its plain version: (max_abs_err, ok,
    what was held, two launches the same bits, the kernel's outputs). The
    tolerances: null vectors to 1e-3 where the two smallest singular values
    are 1e-3 of the largest apart, everywhere a unit vector no worse in
    ``|A v|`` than the plain one's + 1e-4 s_max; the 3 x 3 factors to 1e-3
    where the singular values are apart, rebuilding A to 1e-4 s_max. For a
    tall matrix (more than ``S.MAX_ROWS`` rows) also a CUDA graph of the
    call replayed twice, each replay the eager bits."""
    from structure_from_motion_tpu_torch.tools.svd_cases import null_vector_error

    batch, (M, N) = A.numel() // (A.shape[-1] * A.shape[-2]), A.shape[-2:]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = S.small_svd(A, not full)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    again = S.small_svd(A, not full)
    ref = S.small_svd_reference(A, not full)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    if full:
        s = torch.linalg.svdvals(A.double())
        top = s[..., :1].clamp_min(1e-30)
        gap = ((s[..., :-1] - s[..., 1:]) > 1e-3 * top).all(-1)
        err = max(float((g - r)[gap].abs().max()) if gap.any() else 0.0
                  for g, r in zip(got, ref))
        rebuilt = float(((got[0] * got[1][..., None, :]) @ got[2] - A).abs().max())
        ok = err <= 1e-3 and rebuilt <= 1e-4 * float(top.max())
        tol = (f"vectors and values atol 1e-3 where the singular values are 1e-3 of the "
               f"largest apart ({int(gap.sum())} of {batch}); U S Vh - A {rebuilt:.2e}")
    else:
        v, w = got[2][..., 0, :], ref[2][..., 0, :]
        err, n_gap, unit, slack = null_vector_error(A, v, w)
        ok = (err <= 1e-3 and unit <= 1e-5 and slack <= 0
              and bool(torch.isfinite(v).all()))
        tol = (f"atol 1e-3 where the two smallest singular values are 1e-3 of the largest "
               f"apart ({n_gap} of {batch}); everywhere a unit vector (|1 - |v|| "
               f"{unit:.1e}) with |A v| <= the plain one's + 1e-4 s_max (slack {slack:.1e})")
    tol += f"; two launches same bits: {same}"
    if M > S.MAX_ROWS and not full:
        static = A.clone()
        S.small_svd(static, True)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = S.small_svd(static, True)
        replays = []
        for _ in range(2):
            out[2].zero_()
            g.replay()
            torch.cuda.synchronize()
            replays.append(torch.equal(out[2], got[2]))
        del g
        tol += f"; a graph replayed twice, the eager bits: {replays}"
        same = same and all(replays)
    return err, ok and same, tol, same, got


def _b7_times(torch, S, A, full: bool, got) -> tuple:
    """(kernel ms, plain ms, library ms, bound ms, bound by, the line's
    tail) of B7 on ``A``."""
    batch, (M, N) = A.numel() // (A.shape[-1] * A.shape[-2]), A.shape[-2:]
    ms = _median_ms(torch, lambda: S.small_svd(A, not full))
    plain_ms = _median_ms(torch, lambda: S.small_svd_reference(A, not full))
    full_m = M < N and not full
    library_ms = _median_ms(torch, lambda: torch.linalg.svd(A, full_matrices=full_m))
    moved = A.numel() * 4 + sum(t.numel() * 4 for t in got)
    m, n = max(M, N), min(M, N)
    flops = batch * (2 * m * n * n - 2 * n**3 / 3)  # one QR: the least an SVD does
    t_bytes, t_ops = 1e3 * moved / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
    bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    tail = (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by} ({moved / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP), library "
            f"torch.linalg.svd {library_ms:.4f} ms")
    return ms, plain_ms, library_ms, bound_ms, bound_by, tail


def b7_phase(dev, calls: dict, smi: str) -> list:
    """Kernel B7 against its plain version (``torch.linalg.svd`` under the
    sign rule, :func:`_b7_check`) at every shape the slice launched it with
    (``calls``: the last input at each ``(batch, M, N, full)`` key,
    :func:`svd_inputs`) and on the numpy cases of
    ``tools/svd_cases.cases`` (the tall one-launch reduction at 65,536 x 12
    and with 90% of its rows zero, two close smallest singular values, the
    degenerate samples), with no host synchronisation, the same bits on two
    launches and a tall launch's graph replayed twice; then the minimal PnP
    margin of ``tests/test_torch_geometry.py::
    test_minimal_pnp_poses_under_noise`` on that test's 6-point samples.
    Raises on a disagreement. Returns the kernel's entries (the slice's
    shapes)."""
    import numpy as np
    import torch

    from structure_from_motion_tpu_torch.ops import pnp
    from structure_from_motion_tpu_torch.ops import small_svd as S
    from structure_from_motion_tpu_torch.tools.svd_cases import cases
    from structure_from_motion_tpu_torch.utils.rotations import so3_exp

    if not calls:
        raise AssertionError("kernel B7 was never called eagerly in the slice run")
    results = []
    for key in sorted(calls, key=lambda k: (k[3], k[1] * k[2], k[0])):
        batch, M, N, full = key
        A = calls[key]
        err, ok, tol, same, got = _b7_check(torch, S, A, full)
        ms, plain_ms, library_ms, bound_ms, bound_by, tail = _b7_times(torch, S, A, full, got)
        name = f"B7 small_svd ({batch} x {M} x {N}{', U S Vh' if full else ', null vector'})"
        print(f"kernel {name}: max_abs_err={err:.3e} ({tol}) {tail} ({smi})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        results.append(dict(
            name=name, route="cuda", source="structure_from_motion_tpu_torch/csrc/svd.cu",
            replaces="structure_from_motion_tpu/ops/linalg.py:27 (jnp.linalg.svd; no Pallas "
                     "kernel)", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, shape=key, path="slice"))
    for label, arr in cases().items():
        A = torch.as_tensor(arr).to(dev).contiguous()
        err, ok, tol, same, got = _b7_check(torch, S, A, False)
        *_, tail = _b7_times(torch, S, A, False, got)
        name = f"B7 small_svd (numpy case '{label}': {' x '.join(map(str, A.shape))}, null vector)"
        print(f"kernel {name}: max_abs_err={err:.3e} ({tol}) {tail} ({smi})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")

    # the 6-point samples of test_minimal_pnp_poses_under_noise (seed 13,
    # 240 points, 0.5 px noise), made here with numpy and the port
    rng = np.random.default_rng(13)
    X = rng.uniform([-4, -3, 8], [4, 3, 16], size=(240, 3))
    R1 = so3_exp(torch.tensor([0.02, -0.15, 0.03])).double().numpy()
    C1 = np.array([1.5, 0.1, 0.2])
    x = (X - C1) @ R1
    uv1 = (x[:, :2] / x[:, 2:]) * 500.0 + [320.0, 240.0]
    rng.random(240)  # the test's outlier flags and shifts (none is applied)
    rng.uniform(12, 60, 240)
    rng.choice([-1.0, 1.0], 240)
    rng.normal(size=(240, 2))  # view 0's noise
    uv1 = uv1 + 0.5 * rng.normal(size=(240, 2))
    rng.random(240)  # the test's mask
    meas = ((uv1 - [320.0, 240.0]) / 500.0).astype(np.float32)
    idx = np.stack([rng.permutation(240)[:6] for _ in range(256)])
    Xs = torch.as_tensor(X[idx].astype(np.float32))
    ms_ = torch.as_tensor(meas[idx])

    def centre_err(device, null=None):
        saved = pnp.nullspace
        if null is not None:
            pnp.nullspace = null
        try:
            _, C = pnp.solve_pnp_dlt(Xs.to(device), ms_.to(device))
        finally:
            pnp.nullspace = saved
        return np.linalg.norm(C.cpu().numpy() - C1, axis=1)

    err_b7, err_plain = centre_err(dev), centre_err("cpu")
    err_gram = centre_err(dev, _gram_nullspace)
    med = [float(np.median(e)) for e in (err_b7, err_plain, err_gram)]
    print(f"kernel B7 minimal PnP (256 samples of 6 points, 0.5 px): median centre error B7 "
          f"{med[0]:.4f}, the plain SVD (CPU) {med[1]:.4f}, the f32 gram null vector "
          f"{med[2]:.4f} (bounds: B7 < 1.0 and 5 x B7 < gram, the CPU test's margin)")
    if not (np.isfinite(err_b7).all() and med[0] < 1.0 and 5 * med[0] < med[2]):
        raise AssertionError("B7's minimal PnP poses miss the test's margin")
    return results


def opcheck_phase(dev) -> None:
    """``torch.library.opcheck`` of every ``sfm::`` operator with CUDA
    inputs at one small shape: schema, fake implementation against the
    kernel's outputs, and the operator's registrations."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    f32 = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    cam = torch.randint(0, 3, (8,), generator=g, device=dev, dtype=torch.int32)
    q = f32(8, 4)
    cases = {
        "blur_levels": (f32(64, 80), [0.25, 0.5, 0.25, 0.1, 0.2, 0.4, 0.2, 0.1], [3, 5]),
        "candidate_response": (f32(5, 32, 40), 0.01, 10.0, 2),
        "candidate_block_max": (f32(5, 32, 40), 0.01, 10.0, 2),
        "match_top2": (f32(100, 128), f32(64, 128),
                       torch.rand(64, generator=g, device=dev) < 0.8),
        "ba_blocks": (cam, f32(8, 3), q / q.norm(dim=-1, keepdim=True),
                      f32(8, 3) + torch.tensor([0.0, 0.0, 6.0], device=dev), f32(8, 2),
                      torch.ones(8, device=dev), 3, 0.0),
        "expand_cam": (cam, f32(8, 21), f32(3, 7)),
        "reduce_cam": (f32(8, 21), f32(8, 3),
                       torch.randint(0, 8, (12,), generator=g, device=dev, dtype=torch.int32),
                       torch.rand(12, generator=g, device=dev) < 0.7, 3),
        "small_svd": (f32(4, 8, 9), True),
        "small_svd full": (f32(4, 3, 3), False),
    }
    for name, args in cases.items():
        torch.library.opcheck(getattr(torch.ops.sfm, name.split()[0]).default, args)
        torch.cuda.synchronize()
    print(f"opcheck: {len(cases)} sfm operators pass on {dev} ({', '.join(cases)})")


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

    # every frame renders in worker processes (started fresh, not forked
    # from this process, which holds the card); they are joined, and
    # stopped on a failure, at the end
    pool = ProcessPoolExecutor(max_workers=8, mp_context=multiprocessing.get_context("spawn"))
    try:
        _smoke(torch, dev, smi, pool)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _smoke(torch, dev, smi: str, pool) -> None:
    import numpy as np

    from structure_from_motion_tpu_torch import kernels
    from structure_from_motion_tpu_torch.ops import ba_cuda, ba_matvec, blur_cuda
    from structure_from_motion_tpu_torch.ops import features_cuda, matching, small_svd

    renders = render_all(pool)

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

    # -- the rendered sequences ------------------------------------------------
    t0 = time.perf_counter()
    imgs, K, C_gt, _ = renders["slice"].result()
    small_imgs, small_K, small_C_gt, _ = renders["small"].result()
    lanes = [renders[f"lane{b}"].result() for b in range(BATCH)]
    small_lanes = [renders[f"small lane{b}"].result() for b in range(BATCH)]
    print(f"render: {len(renders)} sequences in worker processes, {time.perf_counter() - t0:.1f} s "
          "waited for them")
    # the map run's lanes: the 600x800 sequence, every other lane mirrored
    # (a mirrored scene under the same K, whose cx is the image centre)
    map_lanes = [([np.ascontiguousarray(im[:, ::-1]) if b % 2 else im for im in small_imgs[:3]],
                  small_K, small_C_gt[:3] * ([-1.0, 1.0, 1.0] if b % 2 else 1.0))
                 for b in range(BATCH)]
    cfg = cli_default_config()

    # -- 4. the slice: the CLI's default slide mode, then finalize_global ----
    slice_kernels = {
        "B1 blur_levels": blur_cuda.blur_levels,
        "B2f candidate_block_max": features_cuda.candidate_block_max,
        "B3 match_top2": matching.match_top2,
        "B4 ba_blocks": ba_cuda.ba_blocks,
        "B7 small_svd": small_svd.small_svd,
    }
    counted = dict(slice_kernels, **{"B2 candidate_response": features_cuda.candidate_response,
                                     "B5 expand_cam": ba_matvec.expand_cam,
                                     "B6 reduce_cam": ba_matvec.reduce_cam})
    loops = LoopRecorder()
    graphed_run, b7_inputs = {}, {}
    with _clock("slice"), loops.installed(), svd_inputs(b7_inputs):
        runs = {"slice": slice_phase(dev, imgs, K, C_gt, cfg, counted, torch.cuda.synchronize, smi,
                                     loops, graphed_run)}
    launches = runs["slice"][0]
    missing = [name for name in slice_kernels if launches[name] < 1]
    if missing:
        raise AssertionError(f"a kernel of the slice never launched: {missing}")
    if launches["B2f candidate_block_max"] != cfg.frontend.num_octaves * len(imgs) \
            or launches["B2 candidate_response"]:
        raise AssertionError(f"the slice's candidate stage is not the fused kernel's: {launches}")

    # -- 13. the frame graph: detect + match replayed against every frame eager
    with _clock("frame graph"):
        frame_graph_phase(dev, imgs, K, cfg, graphed_run, torch.cuda.synchronize, smi)
    del graphed_run

    # -- 11. the slice's frames through an exported artifact -------------------
    with _clock("serve"):
        runs["serve"] = serve_phase(dev, imgs, K, C_gt, cfg, counted, torch.cuda.synchronize, smi)

    # -- 5. the 500-camera global solve --------------------------------------
    with _clock("global"):
        global_launches, single_global = global_phase(dev, counted, torch.cuda.synchronize, smi)
    runs["global"] = (global_launches, {})

    # -- 9. the sharded BA: two ranks on this card, and a one-rank NCCL group --
    with _clock("sharded"):
        sharded_runs, shard_inputs = sharded_phase(dev, imgs[:SHARDED_FRAMES], K,
                                                   C_gt[:SHARDED_FRAMES], cfg, single_global, smi)
    runs.update(sharded_runs)

    # -- 6. the command line ---------------------------------------------------
    with _clock("cli"):
        runs["cli map"] = cli_phase(dev, imgs, small_imgs, K, small_K, C_gt, small_C_gt, cfg,
                                    counted, torch.cuda.synchronize, smi)

    # -- 7. the batched engine ---------------------------------------------------
    with _clock("batched"), loops.installed():
        batched_runs, small_b4 = batched_phase(dev, lanes, small_lanes, map_lanes, cfg, counted,
                                               torch.cuda.synchronize, smi, loops)
    runs.update(batched_runs)

    # -- 8. the Harris frontend through the command line -------------------------
    harris = renders["harris"].result()
    with _clock("harris"):
        runs["harris"], harris_fe, harris_b4 = harris_phase(dev, harris, counted,
                                                            torch.cuda.synchronize, smi)

    # -- 10. the shared sample grid: the CLI on the same frames, then 2 lanes
    with _clock("shared"):
        shared_phase(dev, harris, small_lanes, counted, torch.cuda.synchronize, smi)

    # -- 12. the loops: graph replays against the plain per-step loop ---------
    with _clock("loops"):
        loops_phase(dev, loops, single_global, torch.cuda.synchronize, smi)

    # -- 3. every kernel against its plain version at its paths' shapes (after
    # the runs, whose last B4 inputs it takes) ----------------------------------
    with _clock("kernels"):
        results = kernel_phase(dev, imgs, small_imgs[0], cfg, smi, [s[0][0] for s in lanes],
                               [s[0][0] for s in map_lanes], [s[0][0] for s in small_lanes],
                               harris[0][0], harris_fe, small_b4, harris_b4, shard_inputs)
        results += b7_phase(dev, b7_inputs, smi)
    opcheck_phase(dev)
    for r in results:
        name = r["name"].split(" (")[0].removesuffix(" lanes")
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
