#!/usr/bin/env python3
"""The JAX package's numbers that ``chip_smoke.py`` holds the port's batched
and Harris phases to, taken on the CPU on the same rendered frames.

    JAX_PLATFORMS=cpu python3 jax_reference_bands.py small    # ~1 min
    JAX_PLATFORMS=cpu python3 jax_reference_bands.py harris   # ~3 min
    JAX_PLATFORMS=cpu python3 jax_reference_bands.py shared

``small``: ``BatchedIncrementalSfM`` at ``bench.py``'s small-sequence config
(256 keypoints, 3 octaves, no 2x octave, ratio 0.8, capacities 8 / 256 /
2048 / 8192) on 8 lanes, lane b on ``synthetic_scene_sequence(8, (240,
320), seed=3 + b, loops=0.56)``: each lane's ATE in parts of the
trajectory's span, mean reprojection error and map size.

``harris``: ``python -m structure_from_motion_tpu reconstruct --detector
harris`` (its parser's Harris config, ``blur_impl="pallas"`` through
``--config``) on ``synthetic_scene_sequence(10, (600, 800), seed=3,
loops=0.7)`` written as 24-bit BMP files under ``build/``: ATE in parts of
the span, mean reprojection error, map points.

``shared``: the same CLI at its default (DoG) flags with ``"sampling":
"shared"`` (and ``blur_impl``/``extrema_impl="pallas"``) through
``--config``, on the same frames: ATE in parts of the span, mean
reprojection error, map points.

Prints one JSON object. The frames come from the port's renderer, which
equals the JAX package's bit for bit (``tests/test_torch_config.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def _span_ate(locs, C_gt) -> float:
    from chip_smoke import _umeyama_ate

    return _umeyama_ate(np.asarray(locs), C_gt) / float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))


def small() -> dict:
    import jax

    from structure_from_motion_tpu.config import (
        CapacityConfig,
        FrontendConfig,
        MatcherConfig,
        PipelineConfig,
    )
    from structure_from_motion_tpu.models import BatchedIncrementalSfM
    from structure_from_motion_tpu.models.incremental import pipeline_reprojection_error
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence

    cfg = PipelineConfig(
        frontend=FrontendConfig(max_keypoints=256, num_octaves=3, upsample_first_octave=False),
        matcher=MatcherConfig(ratio=0.8),
        capacity=CapacityConfig(max_views=8, max_keypoints=256, max_points=2048,
                                max_observations=8192),
    )
    B, n = 8, 8
    seqs = [synthetic_scene_sequence(n_frames=n, size=(240, 320), seed=3 + b, loops=0.56)
            for b in range(B)]
    eng = BatchedIncrementalSfM(cfg, seqs[0][1], batch=B, frontend="native", seed=0)
    for t in range(n):
        eng.process_images(np.stack([s[0][t] for s in seqs]).astype(np.float32))
    locs, _ = eng.poses()
    return dict(
        ate_of_span=[_span_ate(locs[b], seqs[b][2]) for b in range(B)],
        reproj=[float(pipeline_reprojection_error(
            jax.tree_util.tree_map(lambda a, b=b: a[b], eng.states))) for b in range(B)],
        points=[int(len(eng.map_points(b))) for b in range(B)],
    )


def _cli_run(name: str, detector: str, **frontend) -> dict:
    """The JAX CLI at its default flags for ``detector``, the frontend fields
    ``frontend`` set through ``--config``, on the 10 rendered 600x800 frames
    written as BMP files."""
    from chip_smoke import write_bmp_gray
    from structure_from_motion_tpu.__main__ import _build_config, main
    from structure_from_motion_tpu.models import IncrementalSfM
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence

    imgs, K, C_gt, _ = synthetic_scene_sequence(n_frames=10, size=(600, 800), seed=3, loops=0.7)
    root = ROOT / "build" / f"jax_reference_{name}"
    shutil.rmtree(root, ignore_errors=True)
    (root / "frames").mkdir(parents=True)
    for i, im in enumerate(imgs):
        write_bmp_gray(str(root / "frames" / f"frame{i:04d}.bmp"), np.asarray(im))
    flags = argparse.Namespace(
        config=None, detector=detector, no_upsample=False, max_kp=2048, ratio=0.75,
        no_gate=False, max_views=16, window_mode="slide", ba_shards=1, dist=None,
        keyframe_min_flow=0.0, max_points=16384, max_observations=65536)
    cfg = _build_config(flags)
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, **frontend))
    (root / "config.json").write_text(cfg.to_json())
    out = root / "out"
    rc = main(["reconstruct", "--images", str(root / "frames"), "--pattern", "*.bmp",
               "--out", str(out), "--fx", repr(float(K[0, 0])), "--fy", repr(float(K[1, 1])),
               "--cx", repr(float(K[0, 2])), "--cy", repr(float(K[1, 2])), "--device", "cpu",
               "--config", str(root / "config.json")])
    if rc != 0:
        raise SystemExit(f"the JAX CLI exited with {rc}")
    rec = np.load(out / "reconstruction.npz")
    eng = IncrementalSfM(cfg, K, frontend="native")
    eng.load_checkpoint(str(out / "state.npz"))
    res = dict(ate_of_span=_span_ate(rec["locations"], C_gt),
               reproj=float(eng.reprojection_error()), points=int(len(rec["points"])))
    shutil.rmtree(root)
    return res


def harris() -> dict:
    return _cli_run("harris", "harris", blur_impl="pallas")


def shared() -> dict:
    return _cli_run("shared", "dog", sampling="shared", blur_impl="pallas",
                    extrema_impl="pallas")


def run(which: str) -> dict:
    """The numbers of one reference run (``small``, ``harris`` or ``shared``)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    res = {"small": small, "harris": harris, "shared": shared}[which]()
    res["seconds"] = time.time() - t0
    return res


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("which", choices=["small", "harris", "shared"])
    print(json.dumps(run(p.parse_args().which)))
