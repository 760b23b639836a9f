"""Command-line entry point: ``python -m structure_from_motion_tpu_torch``
(port of ``structure_from_motion_tpu/__main__.py``; the same subcommands
and flags with the same defaults).

``reconstruct`` runs incremental SfM over a directory of images: files ->
decode -> pinned buffer -> upload on a side stream, one frame ahead
(``io/prefetch.py``) -> ``IncrementalSfM.process_image`` -> checkpoints ->
``reconstruction.npz`` and the exports. It runs on the card unless
``--device cpu`` is given. Differences from the JAX package's CLI:
``--device`` takes ``cuda`` (default) or ``cpu``; ``--compile-cache DIR``
keeps the kernels' build in DIR (``serve.enable_compilation_cache``: the
port compiles nothing else; the default is ``build/torch_kernels/``);
``--ba-shards N`` shards the per-frame bundle
adjustment over N ranks, one a card, so it runs under ``torchrun
--nproc-per-node N`` (every rank reconstructs the same frames, rank r on
``cuda:r`` of its host; only rank 0 writes the outputs). ``--detector
harris`` runs Harris corners with 256-bit steered-BRIEF codes, Hamming
matching and the cross-check, as in the JAX package.

``bundle`` (the port's own subcommand, with a parser of its own beside the
JAX package's two) solves a bundle adjustment problem in the BAL text format
(Agarwal et al., *Bundle Adjustment in the Large*): every camera refines its
pose and its intrinsics (Snavely's model: focal length ``f``, radial ``k1``,
``k2``, principal point at 0) with the points, through the same
``models/global_ba.solve_global`` as the end-of-run solve of
``reconstruct`` (``io/bal.py``; the 10-wide camera block), and writes the
refined problem in the same format. It prints one JSON line: the costs of
the first and last iterations, the PCG iterations and the seconds.

Examples:
    python -m structure_from_motion_tpu_torch reconstruct \\
        --images frames/ --pattern "*.bmp" \\
        --fx 568.996 --fy 568.988 --cx 643.21 --cy 477.98 --out out/

    torchrun --nproc-per-node 2 -m structure_from_motion_tpu_torch reconstruct \\
        --images frames/ --fx 568.996 --fy 568.988 --cx 643.21 --cy 477.98 \\
        --out out/ --ba-shards 2

    python -m structure_from_motion_tpu_torch selftest --device cpu

    python -m structure_from_motion_tpu_torch bundle \
        --problem problem-1778-993923-pre.txt --out venice_refined.txt --iterations 20
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import sys
import time

import numpy as np


def _build_config(args):
    from structure_from_motion_tpu_torch.config import (
        CapacityConfig,
        FrontendConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )

    if args.config:
        with open(args.config) as f:
            return PipelineConfig.from_json(f.read())

    # accuracy is the default price: the 2x first octave ships unless
    # --no-upsample asks for the throughput config (DoG only)
    harris = args.detector == "harris"
    upsample = not harris and not args.no_upsample
    frontend = FrontendConfig(
        detector=args.detector,
        max_keypoints=args.max_kp,
        descriptor_dim=256 if harris else 128,
        upsample_first_octave=upsample,
        num_octaves=5 if upsample else 4,
    )
    matcher = MatcherConfig(
        ratio=args.ratio,
        metric="hamming" if harris else "l2",
        # binary codes: the Hamming ratio test alone is weakly
        # discriminative, so matches must also be mutual nearest neighbours
        cross_check=harris,
        use_fundamental_gate=not args.no_gate,
        gate_ransac=RansacConfig(inlier_threshold=3.0, iteration=128),
    )
    return PipelineConfig(
        frontend=frontend,
        matcher=matcher,
        capacity=CapacityConfig(
            max_views=args.max_views,
            max_keypoints=args.max_kp,
            max_points=args.max_points,
            max_observations=args.max_observations,
        ),
        window_size=args.max_views,
        window_mode=args.window_mode,
        ba_num_shards=args.ba_shards,
        distortion=tuple(args.dist) if args.dist else (),
        keyframe_min_flow_px=args.keyframe_min_flow,
    )


def cmd_reconstruct(args) -> int:
    if args.ba_shards <= 1:
        return _reconstruct(args, args.device)
    from structure_from_motion_tpu_torch.parallel import distributed, make_mesh

    joined = distributed.initialize_distributed(
        backend="nccl" if args.device == "cuda" else "gloo")
    try:
        make_mesh(args.ba_shards)
    except ValueError as e:  # no group of that many ranks: not under torchrun
        print(e, file=sys.stderr)
        return 2
    try:
        device = f"cuda:{distributed.local_rank()}" if args.device == "cuda" else "cpu"
        return _reconstruct(args, device)
    finally:
        if joined:
            distributed.shutdown_distributed()


def _reconstruct(args, device: str) -> int:
    import torch.distributed as dist

    # with sharded BA every rank reconstructs; rank 0 alone writes the outputs
    primary = not dist.is_initialized() or dist.get_rank() == 0
    if args.plot:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("--plot needs matplotlib, which is not installed", file=sys.stderr)
            return 2
    if args.compile_cache:
        from structure_from_motion_tpu_torch.serve import enable_compilation_cache

        enable_compilation_cache(args.compile_cache)

    from structure_from_motion_tpu_torch.io.datasets import load_image_grayscale
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    files = sorted(glob.glob(os.path.join(args.images, args.pattern)))
    if not files:
        print(f"no images match {args.images}/{args.pattern}", file=sys.stderr)
        return 2
    K = np.array([[args.fx, 0.0, args.cx], [0.0, args.fy, args.cy], [0.0, 0.0, 1.0]])
    cfg = _build_config(args)
    if cfg.window_mode != "slide":
        files = files[: args.max_views]
    engine = IncrementalSfM(cfg, K, frontend="native", seed=args.seed, device=device)
    if primary:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "config.json"), "w") as f:
            f.write(cfg.to_json())
    start = 0
    ckpt_path = os.path.join(args.out, "state.npz")
    if args.resume and os.path.exists(ckpt_path):
        frame = engine.load_checkpoint(ckpt_path)
        # resume at the next unseen INPUT file: with keyframe selection on,
        # more inputs were consumed than frames accepted
        start = engine._input_index
        print(f"resumed at frame {frame} (input file {start})")

    # the cache is rank 0's (two ranks writing one file would race)
    cache_dir = os.path.join(args.out, "features") if args.cache_features and primary else None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        # the cache key covers every config knob that changes the features
        fe_tag = hashlib.sha1(
            json.dumps(dataclasses.asdict(cfg.frontend), sort_keys=True).encode()
        ).hexdigest()[:10]

    def feed(path, img=None):
        """One frame, optionally through the on-disk feature cache (re-runs
        skip detection entirely)."""
        if not cache_dir:
            return engine.process_image(img if img is not None else load_image_grayscale(path))
        from structure_from_motion_tpu_torch.utils import checkpoint as ckpt

        cpath = os.path.join(
            cache_dir,
            os.path.basename(path)
            + f".{cfg.frontend.detector}.kp{cfg.frontend.max_keypoints}.{fe_tag}.npz",
        )
        if os.path.exists(cpath):
            xy, desc, valid = ckpt.load_features_cache(cpath)
        else:
            kps, desc = engine.detect(load_image_grayscale(path))
            xy, valid = kps.xy, kps.mask
            ckpt.save_features_cache(cpath, xy, desc, valid)
        return engine.process_features(xy, desc, valid)

    t0 = time.time()
    # filenames of ACCEPTED frames, aligned with engine.poses(); the
    # checkpoint carries keyframe_indices, so the pre-resume prefix is exact
    # (when the count still disagrees -- a foreign checkpoint -- the COLMAP
    # export falls back to generated names rather than mislabel views)
    accepted_names = [os.path.basename(files[j]) for j in engine.keyframe_indices
                      if j < len(files)]
    if cache_dir:
        frame_iter = ((p, None) for p in files[start:])
    else:
        # decode + upload of the NEXT frame overlap the current frame's work
        from structure_from_motion_tpu_torch.io.prefetch import DevicePrefetcher

        frame_iter = iter(DevicePrefetcher(files[start:], load_image_grayscale, device=device))
    for i, (path, img) in enumerate(frame_iter, start=start):
        t1 = time.time()
        info = feed(path, img)
        if info.get("keyframe_skipped"):
            print(f"{os.path.basename(path)}: skipped (median flow "
                  f"{info['flow_px']:.2f}px < {args.keyframe_min_flow}px)")
            continue
        if not info.get("skipped"):
            accepted_names.append(os.path.basename(path))
        msg = "  ".join(
            f"{k}={info[k]}"
            for k in ("frame", "matches", "pnp_inliers", "new_points", "pruned_obs",
                      "pruned_points", "reprojection_px")
            if k in info and (k not in ("pruned_obs", "pruned_points") or info[k])
        )
        print(f"{os.path.basename(path)}: {time.time() - t1:.2f}s  {msg}")
        n_drop = int(info.get("dropped_points", 0)) + int(info.get("dropped_obs", 0))
        if n_drop:
            print(f"  WARNING: capacity overflow -- {info['dropped_points']} points / "
                  f"{info['dropped_obs']} observations dropped so far; raise --max-points/"
                  f"--max-observations", file=sys.stderr)
        if primary and args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            engine.save_checkpoint(ckpt_path)
    total = time.time() - t0

    locs, rots = engine.poses()
    pts = engine.map_points()
    if not primary:
        return 0
    np.savez(os.path.join(args.out, "reconstruction.npz"), locations=locs, rotations=rots,
             points=pts)
    engine.save_checkpoint(ckpt_path)
    from structure_from_motion_tpu_torch.utils.metrics import reprojection_stats

    stats = reprojection_stats(engine.state)
    print(f"\n{len(files)} frames in {total:.2f}s ({len(files) / total:.3f} frames/s); "
          f"{len(pts)} map points -> {args.out}/reconstruction.npz")
    if stats.get("count"):
        print(f"reprojection over {stats['count']} observations: "
              f"mean {stats['mean_px']:.3f}px  median {stats['median_px']:.3f}px  "
              f"p95 {stats['p95_px']:.3f}px")

    if args.export_colmap:
        from structure_from_motion_tpu_torch.io.colmap import export_colmap_text

        h, w = np.asarray(load_image_grayscale(files[0])).shape[:2]
        counts = export_colmap_text(
            os.path.join(args.out, "colmap"), locs, rots, engine.state.K.cpu().numpy(), (w, h),
            image_names=accepted_names if len(accepted_names) == len(locs) else None,
            state=engine.state,
        )
        print(f"COLMAP model -> {args.out}/colmap ({counts['images']} images, "
              f"{counts['points']} points, {counts['observations']} observations)")

    if args.export_tum:
        from structure_from_motion_tpu_torch.io.tum import export_tum_trajectory

        tum_path = os.path.join(args.out, "trajectory.tum")
        # timestamps = accepted INPUT frame indices, so trajectories from
        # runs with different keyframe thinning still associate by frame
        ts = (np.asarray(engine.keyframe_indices, np.float64)
              if len(engine.keyframe_indices) == len(locs) else None)
        n_poses = export_tum_trajectory(tum_path, locs, rots, timestamps=ts)
        print(f"TUM trajectory -> {tum_path} ({n_poses} poses; evo-compatible)")

    if args.export_ply:
        from structure_from_motion_tpu_torch.io.ply import export_ply

        ply_path = os.path.join(args.out, "reconstruction.ply")
        n_verts = export_ply(ply_path, pts, cameras=locs)
        print(f"PLY point cloud -> {ply_path} ({n_verts} vertices)")

    if args.plot:
        _plot(args, engine, files, locs, rots, pts)
    return 0


def _plot(args, engine, files, locs, rots, pts) -> None:
    from structure_from_motion_tpu_torch.io.datasets import load_image_grayscale
    from structure_from_motion_tpu_torch.models import tracks
    from structure_from_motion_tpu_torch.utils.visualization import (
        plot_matches,
        plot_reconstruction_xz,
    )

    out_png = os.path.join(args.out, "reconstruction_xz.png")
    plot_reconstruction_xz(locs, rots, pts, out_path=out_png)
    print(f"plot -> {out_png}")
    # state slots 0/1 are the two OLDEST LIVE views -- under slide mode or
    # keyframe skipping those are NOT files[0]/files[1]; map slots through
    # the accepted-input bookkeeping to the right image files
    n_live = int(engine.state.cam_valid.sum())
    base = len(engine.keyframe_indices) - n_live
    if n_live >= 2 and base >= 0:
        i0, i1 = engine.keyframe_indices[base], engine.keyframe_indices[base + 1]
        if i1 < len(files):
            _, _, ref_xy, que_xy, valid = tracks.matched_pair_arrays(engine.state, 0, 1)
            match_png = os.path.join(args.out, "matches_01.png")
            plot_matches(load_image_grayscale(files[i0]), load_image_grayscale(files[i1]),
                         ref_xy.cpu().numpy(), que_xy.cpu().numpy(), mask=valid.cpu().numpy(),
                         out_path=match_png)
            print(f"match plot -> {match_png}")


def cmd_selftest(args) -> int:
    """Tiny synthetic end-to-end check (no dataset needed)."""
    from structure_from_motion_tpu_torch.config import (
        CapacityConfig,
        FrontendConfig,
        LMConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_sequence
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
    from structure_from_motion_tpu_torch.utils.metrics import absolute_trajectory_error

    cfg = PipelineConfig(
        frontend=FrontendConfig(max_keypoints=512, upsample_first_octave=False),
        matcher=MatcherConfig(ratio=0.9),
        fundamental_ransac=RansacConfig(inlier_threshold=2.0, iteration=128),
        pnp_ransac=RansacConfig(inlier_threshold=8.0, sample_num=6, iteration=256),
        pnp_lm=LMConfig(damping=5.0, iterations=50),
        triangulation_lm=LMConfig(damping=5.0, iterations=25),
        capacity=CapacityConfig(
            max_views=8, max_keypoints=512, max_points=2048, max_observations=8192
        ),
    )
    K, frames, C_gt, _, _ = synthetic_sequence(n_views=4)
    engine = IncrementalSfM(cfg, K, frontend="precomputed", device=args.device)
    for f in frames:
        engine.process_features(*f)
    locs, _ = engine.poses()
    ate = absolute_trajectory_error(locs, C_gt[: len(locs)])
    ok = ate < 0.05
    print(f"selftest ATE={ate:.5f} -> {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_bundle(args) -> int:
    """A BAL problem through the global solve, refined into a BAL file."""
    import torch

    from structure_from_motion_tpu_torch.config import BAConfig
    from structure_from_motion_tpu_torch.io import bal
    from structure_from_motion_tpu_torch.models import global_ba
    from structure_from_motion_tpu_torch.utils.profiling import device_fence

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bundle: no CUDA card (--device cpu runs the kernels' plain versions)",
              file=sys.stderr)
        return 2
    # the squared loss BAL problems are posed with; the damping is
    # Marquardt's, lambda diag(A) (ops/ba.py), from the default schedule
    cfg = BAConfig(huber_delta=0.0)
    t0 = time.perf_counter()
    problem = bal.read_bal(args.problem)
    t_read = time.perf_counter()
    stats: dict = {}
    out, costs = global_ba.solve_global(bal.to_problem(problem, args.device), cfg,
                                        iterations=args.iterations, stats=stats)
    cams, pts = bal.from_state(out, len(problem.points))
    refined = problem._replace(cameras=cams.cpu().numpy(), points=pts.cpu().numpy())
    device_fence()
    t_solve = time.perf_counter()
    bal.write_bal(args.out, refined)
    print(json.dumps({
        "cameras": len(problem.cameras), "points": len(problem.points),
        "observations": len(problem.cam), "cost_first": float(costs[0]),
        "cost_last": float(costs[-1]), "pcg_iterations": int(sum(stats["cg_iterations"])),
        "read_s": t_read - t0, "solve_s": t_solve - t_read,
        "write_s": time.perf_counter() - t_solve, "out": args.out}))
    return 0


def build_bundle_parser() -> argparse.ArgumentParser:
    b = argparse.ArgumentParser(
        prog="structure_from_motion_tpu_torch bundle",
        description="self-calibrating bundle adjustment of a BAL problem (pose, f, k1, k2 a "
                    "camera) through the global solve")
    b.add_argument("--problem", required=True, help="BAL text file to solve")
    b.add_argument("--out", required=True, help="where to write the refined problem (BAL text)")
    b.add_argument("--iterations", type=int, default=20, help="LM iterations")
    b.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the hand-written kernels and needs a card; cpu runs their "
                        "plain versions")
    return b


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="structure_from_motion_tpu_torch",
        epilog="bundle: solve a BAL bundle adjustment problem "
               "(python -m structure_from_motion_tpu_torch bundle --help)")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("reconstruct", help="incremental SfM over an image directory")
    r.add_argument("--images", required=True)
    r.add_argument("--pattern", default="*.bmp")
    r.add_argument("--out", required=True)
    r.add_argument("--fx", type=float, required=True)
    r.add_argument("--fy", type=float, required=True)
    r.add_argument("--cx", type=float, required=True)
    r.add_argument("--cy", type=float, required=True)
    r.add_argument(
        "--dist", type=float, nargs="+", default=None, metavar="D",
        help="lens distortion coefficients k1 k2 [p1 p2 [k3]] (OpenCV Brown-Conrady); "
             "keypoints are undistorted on the device at ingest",
    )
    r.add_argument("--config", help="PipelineConfig JSON (overrides flags)")
    r.add_argument("--detector", choices=["dog", "harris"], default="dog")
    r.add_argument("--max-kp", type=int, default=2048)
    r.add_argument("--ratio", type=float, default=0.75)
    r.add_argument("--no-gate", action="store_true")
    r.add_argument(
        "--no-upsample", action="store_true",
        help="throughput config: skip the 2x first octave (default is the accuracy config)",
    )
    r.add_argument("--max-views", type=int, default=16)
    r.add_argument(
        "--window-mode", choices=["stop", "slide"], default="slide",
        help="past max-views frames: stop, or slide (evict the oldest view, archive its "
             "pose, keep reconstructing)",
    )
    r.add_argument("--max-points", type=int, default=16384)
    r.add_argument("--max-observations", type=int, default=65536)
    r.add_argument("--ba-shards", type=int, default=1,
                   help="shard BA points/observations over this many ranks (distributed Schur "
                        "LM; run under torchrun --nproc-per-node N; 1 = single device)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the hand-written kernels and needs a card; cpu runs their "
                        "plain versions")
    r.add_argument("--resume", action="store_true")
    r.add_argument(
        "--cache-features", action="store_true",
        help="cache detected features per image under <out>/features/ and reuse them on "
             "re-runs",
    )
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--plot", action="store_true")
    r.add_argument(
        "--export-colmap", action="store_true",
        help="also write a COLMAP text model (cameras/images/points3D.txt) under "
             "<out>/colmap/",
    )
    r.add_argument(
        "--keyframe-min-flow", type=float, default=0.0, metavar="PX",
        help="admit a frame only when its median match displacement vs the last accepted "
             "frame is at least PX pixels (0 = every frame); recommended for video input in "
             "--window-mode slide",
    )
    r.add_argument(
        "--export-tum", action="store_true",
        help="also write the camera trajectory as <out>/trajectory.tum (TUM format: "
             "timestamp tx ty tz qx qy qz qw)",
    )
    r.add_argument(
        "--export-ply", action="store_true",
        help="also write the sparse map + camera centers as <out>/reconstruction.ply",
    )
    r.add_argument(
        "--compile-cache", metavar="DIR", default=None,
        help="build the CUDA kernels into DIR and reuse that build in later runs (the port "
             "compiles nothing else; default build/torch_kernels/)",
    )
    r.set_defaults(fn=cmd_reconstruct)

    s = sub.add_parser("selftest", help="synthetic end-to-end smoke test")
    s.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    s.set_defaults(fn=cmd_selftest)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["bundle"]:
        return cmd_bundle(build_bundle_parser().parse_args(argv[1:]))
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
