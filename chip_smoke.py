#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing its numbers on its own line; any failure raises and
the script exits non-zero without printing the final result line:

1. environment: a CUDA card must be visible; prints its nvidia-smi name and
   power limit, the torch/CUDA versions and both TF32 switches;
2. build: compiles ``structure_from_motion_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernels: each of the four Hopper kernels against its plain PyTorch
   version on the card, at the shapes the main path gives it, with the
   tolerance stated beside it, and the median CUDA-event time of both;
4. slice: ten rendered 960x1280 frames through the port's
   ``IncrementalSfM`` at the CLI's default reconstruct configuration, with
   every kernel's launch count, the per-frame wall time, and the
   similarity-aligned ATE and mean reprojection error against the exact
   rendered ground truth.

The last two lines are a JSON object of the kernels' numbers and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

RENDER = dict(n_frames=10, size=(960, 1280), seed=3, loops=0.7)
ATE_BOUND = 0.05  # of the trajectory span (tests/test_synthetic_gt.py:86-90)
REPROJ_BOUND_PX = 2.0


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
    defaults ``:366-382``), in window mode "stop"."""
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
        window_mode="stop",
    )


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
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
    from structure_from_motion_tpu_torch.ops import blur_cuda, features, features_cuda
    from structure_from_motion_tpu_torch.ops import ba_cuda, matching

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
              f"plain {plain_ms:.4f} ms")
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
    torch.cuda.empty_cache()

    # -- 4. the slice --------------------------------------------------------
    counted = {
        "B1 blur_levels": blur_cuda.blur_levels,
        "B2 candidate_response": features_cuda.candidate_response,
        "B3 match_top2": matching.match_top2,
        "B4 ba_blocks": ba_cuda.ba_blocks,
    }
    for fn in counted.values():
        fn.launches = 0
    engine = IncrementalSfM(cfg, K, frontend="native", seed=0, device=dev)
    frame_s = []
    for im in imgs:
        t0 = time.perf_counter()
        info = engine.process_image(im)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        print(f"slice frame {info['frame']}: {frame_s[-1]:.3f} s, matches {int(info['matches'])}, "
              f"pnp_inliers {int(info['pnp_inliers'])}, new_points {int(info['new_points'])}, "
              f"reprojection {info['reprojection_px']:.4f} px")
    launches = {name: fn.launches for name, fn in counted.items()}
    for r in results:
        r["launches"] = launches[r["name"]]
    print(f"slice launches: {launches}")
    print(f"slice frame time: first (frame 0) {frame_s[0]:.3f} s, bootstrap (frame 1) "
          f"{frame_s[1]:.3f} s, frames 2-9 median {float(np.median(frame_s[2:])):.3f} s, "
          f"total {sum(frame_s):.3f} s")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    locs, _ = engine.poses()
    span = float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))
    ate = _umeyama_ate(locs, C_gt)
    reproj = engine.reprojection_error()
    print(f"slice quality: ATE {ate:.5f} = {ate / span:.5f} of span (bound {ATE_BOUND}), "
          f"reprojection {reproj:.4f} px (bound {REPROJ_BOUND_PX}), "
          f"map points {len(engine.map_points())}")
    if not (locs.shape == (10, 3) and np.isfinite(locs).all()):
        raise AssertionError("poses missing or not finite")
    if not (ate / span < ATE_BOUND and reproj < REPROJ_BOUND_PX):
        raise AssertionError("slice quality outside its bounds")
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
