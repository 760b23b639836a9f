"""Device time of the redesigned kernels B1, B3, B4 and B6, kernel by kernel.

Run on a machine with an NVIDIA card, from the repository root:

    python3 -m structure_from_motion_tpu_torch.tools.profile_kernels [--only B1,B6]

For B1 (``blur_levels``) at the six shapes a 960x1280 frame launches it at
(the base blur, 1920x2560 with one level of radius 4, then the five levels
of the default sigmas at the octaves from 1920x2560 down to 120x160); for
B4 (``ba_blocks``) at (O, V) = (262144, 16), (233984, 16) and (233984, 500)
with random camera ids; for B3 (``match_top2``) at 32768 x 2048 x 128; and
for B6 (``reduce_cam``) over
the camera-major view of the 500-camera checkpoint's stream (``--artifact``,
by default ``artifacts/longrun500_pre_globalba.ckpt.npz``), it prints what
``torch.profiler`` measured for each CUDA kernel of a wrapper call (mean
device time over the repeats, so the stages of a wrapper show apart and
launch overhead is left out), the wrapper's CUDA-event time with a warm L2
and after 64 MB of other traffic, and the achieved rates against the bytes
and operations the function needs. Every line carries the card's name and
power limit.

It calls only the wrappers, so the same file runs against another version
of the kernels: copy it over that version's ``tools/profile_kernels.py``
and run it from that checkout, within one run on one card.
"""

from __future__ import annotations

import argparse
import math
import subprocess
from pathlib import Path

import numpy as np
import torch

from structure_from_motion_tpu_torch.config import FrontendConfig
from structure_from_motion_tpu_torch.models import global_ba
from structure_from_motion_tpu_torch.ops import ba, ba_cuda, ba_matvec, blur_cuda
from structure_from_motion_tpu_torch.ops import features, matching
from structure_from_motion_tpu_torch.utils import checkpoint

REPS = 30
ARTIFACT = Path(__file__).resolve().parents[2] / "artifacts" / "longrun500_pre_globalba.ckpt.npz"
_KERNEL_NAMES = ("ba_", "match_top2", "blur_", "reduce_cam")


def _event_ms(fn, flush=None) -> float:
    """Median time between two CUDA events around one wrapper call. The card
    first spins ~0.3 ms (after the optional flush) so that the host has
    enqueued the call before the first event fires: device time, not the
    host's enqueue time."""
    times = []
    for _ in range(REPS):
        if flush is not None:
            flush.add_(1.0)
        torch.cuda._sleep(500_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_times(fn) -> dict:
    """Mean device microseconds per launch, by kernel name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0 and any(k in ev.key for k in _KERNEL_NAMES):
            name = ev.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            out[name.split("(")[0]] = dev_us / ev.count
    return out


def _report(name, fn, moved, flops, flush, card):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    warm, cold = _event_ms(fn), _event_ms(fn, flush)
    parts = _device_times(fn)
    total_us = sum(parts.values())
    print(f"{name}: event time warm L2 {warm:.4f} ms, after a 64 MB flush {cold:.4f} ms; "
          f"device time by kernel (us): "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
          + f"; sum {total_us:.2f} us = {moved / total_us / 1e6:.3f} TB/s of the {moved / 1e6:.2f} "
          f"MB it must move, {flops / total_us / 1e6:.2f} TFLOP/s of its {flops / 1e9:.3f} GFLOP "
          f"({card})")


def frame_kernels():
    """The taps a frame blurs with at the default sigmas: the five relative
    kernels of an octave (radii 4, 6, 9, 12, 15) and the base blur's one."""
    fe = FrontendConfig()
    S = fe.scales_per_octave
    sig = [fe.sigma0 * 2.0 ** (i / S) for i in range(S + 3)]
    rel = [features._gaussian_kernel1d(math.sqrt(s**2 - sig[0] ** 2)) for s in sig[1:]]
    return rel, [features._gaussian_kernel1d(math.sqrt(fe.sigma0**2 - 1.0))]


def frame_shapes():
    """(label, (H, W), taps) of B1's six launches on a 960x1280 frame."""
    rel, base_k = frame_kernels()
    return [("base blur", (1920, 2560), base_k)] + [
        (f"octave {o}", (1920 >> o, 2560 >> o), rel) for o in range(5)]


def global_stream(dev, rng, artifact: str):
    """B6's inputs over the checkpoint's tiered stream, W and y random:
    (w21, y, perm, mask, O, V, rows)."""
    state, frame, archive, _ = checkpoint.load_state(artifact, dev)
    prob = global_ba.build_global_problem(state, archive, min(frame, 8))
    st, obs, _, _, cam_rows = global_ba.tiered_problem(prob)
    O, V = obs.cam.shape[0], st.C.shape[0]
    w21 = torch.as_tensor(rng.normal(size=(O, 21)).astype(np.float32)).to(dev)
    y = torch.as_tensor(rng.normal(size=(O, 3)).astype(np.float32)).to(dev)
    perm, mask = ba.compute_cam_ell(obs.cam.contiguous(), obs.valid, V, cam_rows)
    return w21, y, perm, mask, O, V, cam_rows


def _b1_cases(dev, rng, card, flush) -> None:
    for label, (h, w), ks in frame_shapes():
        img = torch.as_tensor(rng.random((h, w)).astype(np.float32)).to(dev)
        _report(f"B1 blur_levels {label}: {h}x{w}, radii {[len(k) // 2 for k in ks]}",
                lambda: blur_cuda.blur_levels(img, ks), 4 * h * w * (1 + len(ks)),
                sum(2 * 2 * len(k) for k in ks) * h * w, flush, card)


def _b6_case(dev, rng, card, flush, artifact: str) -> None:
    w21, y, perm, mask, O, V, cam_rows = global_stream(dev, rng, artifact)
    filled = int(mask.sum())
    # the function reads the W and y rows of the filled slots only
    _report(f"B6 reduce_cam {V} cameras x {cam_rows} slots, {filled} filled, O = {O}",
            lambda: ba_matvec.reduce_cam(w21, y, perm, mask, V),
            filled * (84 + 12) + perm.numel() * 5 + 28 * V, 2 * 21 * filled, flush, card)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="B1,B3,B4,B6", help="kernels to time, e.g. B1,B6")
    ap.add_argument("--artifact", default=str(ARTIFACT), help="checkpoint whose stream B6 walks")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    flush = torch.zeros(16 * 1024 * 1024, dtype=torch.float32, device=dev)
    if "B1" in only:
        _b1_cases(dev, rng, card, flush)
    if "B6" in only:
        _b6_case(dev, rng, card, flush, args.artifact)

    for O, V in ((262144, 16), (233984, 16), (233984, 500)) if "B4" in only else ():
        cam = torch.as_tensor(rng.integers(0, V, O).astype(np.int32)).to(dev)
        f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(dev)  # noqa: E731
        q = f(O, 4) * 0.05
        q[:, 0] += 1.0
        X = f(O, 3)
        X[:, 2] += 10.0
        bargs = (cam, f(O, 3), q, X, f(O, 2) * 0.1,
                 torch.as_tensor((rng.random(O) < 0.3).astype(np.float32)).to(dev), V, 0.01)
        _report(f"B4 ba_blocks O = {O}, V = {V}", lambda: ba_cuda.ba_blocks(*bargs),
                188 * O + 228 * V, 400 * O, flush, card)

    if "B3" not in only:
        return

    def unit(n):
        d = np.abs(rng.normal(size=(n, 128))).astype(np.float32)
        return torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True)).to(dev)

    ref, que = unit(32768), unit(2048)
    mask = torch.ones(2048, dtype=torch.bool, device=dev)
    # the wrapper also runs |q|^2, |r|^2 and the clamps in PyTorch; only the
    # kernel's own time enters the rates
    _report("B3 match_top2 32768 x 2048 x 128 (rates count one f32 product, 17.2 GFLOP; the "
            "kernel runs three TF32 products)", lambda: matching.match_top2(ref, que, mask),
            4 * 128 * (32768 + 2048) + 12 * 32768, 2 * 32768 * 2048 * 128, flush, card)


if __name__ == "__main__":
    main()
