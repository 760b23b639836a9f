"""The last PCG matvec inputs of the sharded 500-camera solve, run after run.

    python3 -m structure_from_motion_tpu_torch.tools.sharded_matvec_inputs [--runs 10]

Two gloo ranks on one card solve ``artifacts/longrun500_pre_globalba.ckpt.npz``
with ``finalize_global(20, num_shards=2)`` ``--runs`` times. For each run,
rank 0 prints one JSON line: the final cost, and for the last inputs of
kernel B5 (the last CG direction ``x``): ``max |x|``, ``max |t|`` of the
plain version's output, the largest sum of the products' magnitudes
``sum_i |W_oi| |x_i|`` (a sum's conditioning), and the kernel's and the plain
version's distances to a float64 evaluation and to each other. The tail of
the sharded stream sums in no fixed order, so the runs differ; this is what
``chip_smoke.py``'s sharded B5 entry is held against. Run it from the root
of a checkout (or of an unpacked parent, to compare two versions).
"""

from __future__ import annotations

import argparse
import json
import socket

import numpy as np
import torch


def _rank(rank: int, port: int, runs: int, out) -> None:
    import torch.distributed as dist

    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
    from structure_from_motion_tpu_torch.ops import ba as ba_module
    from structure_from_motion_tpu_torch.ops import ba_matvec
    from structure_from_motion_tpu_torch.tools.slice_frames import (
        ARTIFACT,
        _long_sequence_config,
    )

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    res = []
    real = ba_module.expand_cam
    try:
        for _ in range(runs):
            eng = IncrementalSfM(_long_sequence_config(), np.eye(3), frontend="precomputed",
                                 device="cuda")
            eng.load_checkpoint(str(ARTIFACT))
            seen = {}

            def spy(*args):
                seen["args"] = args
                return real(*args)

            ba_module.expand_cam = spy
            try:
                info = eng.finalize_global(iterations=20, num_shards=2)
            finally:
                ba_module.expand_cam = real
            cam, w21, x = seen["args"]
            t = ba_matvec.expand_cam(cam, w21, x)
            t_ref = ba_matvec.expand_cam_reference(cam, w21, x)
            t64 = ba_matvec.expand_cam_reference(cam, w21.double(), x.double())
            mag = ba_matvec.expand_cam_reference(cam, w21.abs().double(), x.abs().double())
            res.append(dict(final_cost=float(info["costs"][-1]), max_x=float(x.abs().max()),
                            max_t=float(t_ref.abs().max()), max_magnitude=float(mag.max()),
                            kernel_to_plain=float((t - t_ref).abs().max()),
                            kernel_to_f64=float((t - t64).abs().max()),
                            plain_to_f64=float((t_ref - t64).abs().max())))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        out.put(res)


def run(runs: int) -> list:
    import subprocess

    import torch.multiprocessing as mp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, runs, out)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = out.get(timeout=120 + 60 * runs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r in res:
        print(json.dumps(dict(r, card=card)), flush=True)
    return res


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=10)
    run(p.parse_args().runs)
