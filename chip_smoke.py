#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing its numbers on its own line; any failure raises and
the script exits non-zero without printing the final result line:

1. environment: a CUDA card must be visible; prints its nvidia-smi name and
   power limit, the torch/CUDA versions and both TF32 switches;
2. build: compiles ``structure_from_motion_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernels: each of the six Hopper kernels against its plain PyTorch
   version on the card, at the shapes its path gives it, with the
   tolerance stated beside it, and the median CUDA-event time of both:
   B1-B4 at the per-frame slice's shapes, then B4, B5 and B6 at the shape
   of the 500-camera global solve (the real stream of
   ``artifacts/longrun500_pre_globalba.ckpt.npz``);
4. slice: 24 rendered 960x1280 frames through the port's
   ``IncrementalSfM`` at the CLI's default reconstruct configuration
   (window 16 in slide mode, so frames 16-23 evict and archive a view),
   then ``finalize_global`` over all 24 cameras (a dense Schur solve);
   every kernel's launch count, the per-frame wall time, and the
   similarity-aligned ATE (before and after the global solve) and mean
   reprojection error against the exact rendered ground truth;
5. global: the 500-camera checkpoint loaded with the port's
   ``load_checkpoint`` and solved by ``finalize_global(iterations=20)``
   (tiered layout, PCG through B5/B6): problem size, CG iterations per LM
   step, costs, synchronised wall time, launches, and the final cost
   against the JAX package's f32 result for the same input.

Every phase's launch counts are set to 0 just before it and read just
after. The last two lines are a JSON object of the kernels' numbers and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

# 0.07 loops per frame, the motion of tests/test_synthetic_gt.py:77-79
RENDER = dict(n_frames=24, size=(960, 1280), seed=3, loops=1.68)
ATE_BOUND = 0.05  # of the trajectory span (tests/test_synthetic_gt.py:86-90)
REPROJ_BOUND_PX = 2.0
ARTIFACT = Path(__file__).resolve().parent / "artifacts" / "longrun500_pre_globalba.ckpt.npz"
# final cost of the JAX package's f32 solve of the artifact on the CPU
# (solve_global(iterations=20), BAConfig(huber_delta=0.01))
JAX_GLOBAL_COST = 0.5122


def _median_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    import numpy as np

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
    from structure_from_motion_tpu.config import (
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
    from structure_from_motion_tpu.config import (
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


def slice_phase(dev, imgs, K, C_gt, cfg, counted, sync, card: str) -> dict:
    """Frames through the engine in slide mode, then ``finalize_global``;
    raises when a bound fails. Returns the launch counts of the phase.
    ``card`` (name and power limit) is printed beside every time."""
    import numpy as np

    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    n = len(imgs)
    window = cfg.window_size
    for fn in counted.values():
        fn.launches = 0
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
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"slice launches: {launches}")
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
    return launches


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
    for fn in counted.values():
        fn.launches = 0
    sync()
    t0 = time.perf_counter()
    info = engine.finalize_global(iterations=20)
    sync()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
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
    for name in ("B4 ba_blocks", "B5 expand_cam", "B6 reduce_cam"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched in the global solve: {launches}")
    return launches


def main() -> None:
    import torch

    # -- 1. environment ----------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import numpy as np

    import structure_from_motion_tpu_torch as port

    # the port under test is the checkout this script sits in, never an
    # installed copy elsewhere
    if Path(port.__file__).resolve().parents[1] != Path(__file__).resolve().parent:
        raise SystemExit(f"chip_smoke: run from the repository root (found {port.__file__})")
    from structure_from_motion_tpu.io.synthetic import synthetic_scene_sequence
    from structure_from_motion_tpu_torch import kernels
    from structure_from_motion_tpu_torch.models import global_ba
    from structure_from_motion_tpu_torch.ops import ba, ba_cuda, ba_matvec, blur_cuda
    from structure_from_motion_tpu_torch.ops import features, features_cuda, matching
    from structure_from_motion_tpu_torch.utils import checkpoint

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

    # -- 3. kernels against their plain versions at the slice's shapes -----
    imgs, K, C_gt, _ = synthetic_scene_sequence(**RENDER)
    cfg = cli_default_config()
    fe = cfg.frontend
    img = torch.as_tensor(imgs[0]).to(dev).to(torch.float32)
    img = img / img.max()
    base = features._blur(features._upsample2x(img), math.sqrt(fe.sigma0**2 - 1.0))
    S = fe.scales_per_octave
    sig = [fe.sigma0 * 2.0 ** (i / S) for i in range(S + 3)]
    rel = [features._gaussian_kernel1d(math.sqrt(s**2 - sig[0] ** 2)) for s in sig[1:]]
    rng = np.random.default_rng(0)
    results = []

    def record(name, src, replaces, err, tol, fn, plain, ok):
        ms, plain_ms = _median_ms(torch, fn), _median_ms(torch, plain)
        print(f"kernel {name}: max_abs_err={err:.3e} ({tol}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms ({smi})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        results.append(dict(name=name, route="cuda",
                            source=f"structure_from_motion_tpu_torch/csrc/{src}",
                            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # B1: 1920x2560 base, the 5 relative kernels of one octave
    got = blur_cuda.blur_levels(base, rel)
    ref = blur_cuda.blur_levels_reference(base, rel)
    err = float((got - ref).abs().max())
    record("B1 blur_levels", "blur.cu", "structure_from_motion_tpu/ops/blur_pallas.py:85",
           err, "atol 2e-5", lambda: blur_cuda.blur_levels(base, rel),
           lambda: blur_cuda.blur_levels_reference(base, rel), err <= 2e-5)

    # B2: (5, 1920, 2560) DoG of the rendered frame
    gauss = torch.cat([base[None], got])
    dog = (gauss[1:] - gauss[:-1]).contiguous()
    args = (fe.contrast_threshold, fe.edge_threshold, 8)
    got = features_cuda.candidate_response(dog, *args)
    ref = features_cuda.candidate_response_reference(dog, *args)
    err = float((got - ref).abs().max())
    record("B2 candidate_response", "cand.cu",
           "structure_from_motion_tpu/ops/features_pallas.py:95", err, "atol 0 (exact)",
           lambda: features_cuda.candidate_response(dog, *args),
           lambda: features_cuda.candidate_response_reference(dog, *args), err == 0.0)
    print(f"kernel B2 candidates: {int((got > 0).sum())} nonzero of {got.numel()}")

    # B3: 16 views x 2048 reference rows against 2048 query rows, D = 128;
    # unit-norm rows (the tolerance is stated for unit-norm descriptors: the
    # pipeline's x512 scale multiplies every d^2 and its rounding by 512^2)
    def descriptors(n):
        d = np.abs(rng.normal(size=(n, 128))).astype(np.float32)
        return torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True)).to(dev)

    ref_d, que_d = descriptors(16 * 2048), descriptors(2048)
    mask_q = torch.as_tensor(rng.random(2048) < 0.9).to(dev)
    g1, g2, gj = matching.match_top2(ref_d, que_d, mask_q)
    r1, r2, rj = matching.match_top2_reference(ref_d, que_d, mask_q)
    err = float(max((g1 - r1).abs().max(), (g2 - r2).abs().max()))
    close = all(bool(((a - b).abs() <= 1e-4 + 1e-5 * b.abs()).all())
                for a, b in ((g1, r1), (g2, r2)))
    gap = (r2 - r1) > 1e-3
    same_j = bool((gj == rj)[gap].all())
    record("B3 match_top2", "match_top2.cu", "structure_from_motion_tpu/ops/matching.py:220",
           err, "d^2 rtol 1e-5 atol 1e-4, j1 equal where d2^2-d1^2 > 1e-3",
           lambda: matching.match_top2(ref_d, que_d, mask_q),
           lambda: matching.match_top2_reference(ref_d, que_d, mask_q), close and same_j)

    # B4: the full ELL stream, 16384 points x 16 slots, V = 16
    O, V = 16384 * 16, 16
    cam = torch.as_tensor(rng.integers(0, V, O).astype(np.int32)).to(dev)
    Cv = rng.normal(size=(V, 3)).astype(np.float32)
    qv = (np.float32([1, 0, 0, 0]) + 0.05 * rng.normal(size=(V, 4))).astype(np.float32)
    X = (rng.normal(size=(O, 3)) * [3, 2, 1] + [0, 0, 10]).astype(np.float32)
    c = cam.cpu().numpy()
    uv = ((X[:, :2] - Cv[c, :2]) / (X[:, 2:] - Cv[c, 2:])
          + 0.003 * rng.normal(size=(O, 2))).astype(np.float32)
    w = (rng.random(O) < 0.3).astype(np.float32)
    inp = [torch.as_tensor(a).to(dev) for a in (Cv[c], qv[c], X, uv, w)]
    bargs = (cam, *inp, V, 0.01)
    got = ba_cuda.ba_blocks(*bargs)
    ref = ba_cuda.ba_blocks_reference(*bargs)
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    scaled = [e / max(1.0, float(b.abs().max())) for e, b in zip(errs, ref)]
    record("B4 ba_blocks", "ba_blocks.cu", "structure_from_motion_tpu/ops/ba_pallas.py:163",
           max(errs), f"1e-3 x max(1, |value|); worst scaled {max(scaled):.2e}",
           lambda: ba_cuda.ba_blocks(*bargs), lambda: ba_cuda.ba_blocks_reference(*bargs),
           max(scaled) <= 1e-3)
    del got, ref, gauss, dog, ref_d, que_d, inp

    # B4, B5, B6 at the global solve's shape: the tiered stream of the
    # 500-camera checkpoint (233,984 slots, V = 500)
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
    got = ba_cuda.ba_blocks(*bargs)
    ref = ba_cuda.ba_blocks_reference(*bargs)
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    scaled = [e / max(1.0, float(b.abs().max())) for e, b in zip(errs, ref)]
    print(f"kernel global shape: O = {O} slots, V = {V}, tiers {tiers}, cam_rows {cam_rows}")
    record("B4 ba_blocks (global shape)", "ba_blocks.cu",
           "structure_from_motion_tpu/ops/ba_pallas.py:163", max(errs),
           f"1e-3 x max(1, |value|); worst scaled {max(scaled):.2e}",
           lambda: ba_cuda.ba_blocks(*bargs), lambda: ba_cuda.ba_blocks_reference(*bargs),
           max(scaled) <= 1e-3)
    w21 = got[3].reshape(O, 21)
    del ref
    x = torch.as_tensor(rng.normal(size=(V, 7)).astype(np.float32)).to(dev)
    t = ba_matvec.expand_cam(gcam, w21, x)
    t_ref = ba_matvec.expand_cam_reference(gcam, w21, x)
    err = float((t - t_ref).abs().max())
    bound = 1e-5 * max(1.0, float(t_ref.abs().max()))
    record("B5 expand_cam", "ba_matvec.cu", "structure_from_motion_tpu/ops/ba_matvec_pallas.py:91",
           err, f"1e-5 x max(1, |t|) = {bound:.3e}",
           lambda: ba_matvec.expand_cam(gcam, w21, x),
           lambda: ba_matvec.expand_cam_reference(gcam, w21, x), err <= bound)
    y = torch.as_tensor(rng.normal(size=(O, 3)).astype(np.float32)).to(dev)
    perm, mask = ba.compute_cam_ell(gcam, obs.valid, V, cam_rows)
    c1 = ba_matvec.reduce_cam(w21, y, perm, mask, V)
    c2 = ba_matvec.reduce_cam(w21, y, perm, mask, V)
    c_ref = ba_matvec.reduce_cam_reference(w21, y, perm, mask, V)
    err = float((c1 - c_ref).abs().max())
    bound = 1e-4 * max(1.0, float(c_ref.abs().max()))
    same = bool(torch.equal(c1, c2))
    record("B6 reduce_cam", "ba_matvec.cu",
           "structure_from_motion_tpu/ops/ba_matvec_pallas.py:125",
           err, f"1e-4 x max(1, |coup|) = {bound:.3e}; two launches same bits: {same}",
           lambda: ba_matvec.reduce_cam(w21, y, perm, mask, V),
           lambda: ba_matvec.reduce_cam_reference(w21, y, perm, mask, V), err <= bound and same)
    del state, archive, prob, st, obs, got, bargs, w21, t, t_ref, y, perm, mask
    torch.cuda.empty_cache()

    # -- 4. the slice: the CLI's default slide mode, then finalize_global ----
    slice_kernels = {
        "B1 blur_levels": blur_cuda.blur_levels,
        "B2 candidate_response": features_cuda.candidate_response,
        "B3 match_top2": matching.match_top2,
        "B4 ba_blocks": ba_cuda.ba_blocks,
    }
    counted = dict(slice_kernels, **{"B5 expand_cam": ba_matvec.expand_cam,
                                     "B6 reduce_cam": ba_matvec.reduce_cam})
    launches = slice_phase(dev, imgs, K, C_gt, cfg, counted, torch.cuda.synchronize, smi)
    missing = [name for name in slice_kernels if launches[name] < 1]
    if missing:
        raise AssertionError(f"a kernel of the slice never launched: {missing}")

    # -- 5. the 500-camera global solve --------------------------------------
    g_launches = global_phase(dev, counted, torch.cuda.synchronize, smi)
    for r in results:
        name = r["name"].replace(" (global shape)", "")
        in_slice = name == r["name"] and name in slice_kernels
        r["launches"] = (launches if in_slice else g_launches)[name]
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
