"""Wall time a frame of the single-sequence engine at the CLI's default
reconstruct configuration, on rendered 960x1280 frames.

    python3 -m structure_from_motion_tpu_torch.tools.slice_frames [--frames 16] [--repeat 1]

Each repeat builds a fresh ``IncrementalSfM`` (seed 0) and times every
frame between two ``torch.cuda.synchronize()`` calls; prints one JSON line
a repeat with the median of frames 2 onward. To compare two versions on
one card, unpack the other version's package under ``build/`` (git
ignores it), copy this file over its copy, and run both from one command,
in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


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


def run(frames: int, repeat: int) -> list:
    from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    imgs, K, _, _ = synthetic_scene_sequence(n_frames=frames, size=(960, 1280), seed=3,
                                             loops=0.07 * frames)
    cfg = cli_default_config()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = []
    for _ in range(repeat):
        eng = IncrementalSfM(cfg, K, frontend="native", seed=0, device="cuda")
        times = []
        for im in imgs:
            t0 = time.perf_counter()
            eng.process_image(im)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out.append(dict(median_s=float(np.median(times[2:])),
                         times_s=[round(t, 4) for t in times],
                         card=card))
        print(json.dumps(out[-1]))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--repeat", type=int, default=1)
    a = p.parse_args()
    run(a.frames, a.repeat)
