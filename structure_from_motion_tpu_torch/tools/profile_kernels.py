"""Device time of the redesigned kernels B3 and B4, kernel by kernel.

Run on a machine with an NVIDIA card, from the repository root:

    python3 -m structure_from_motion_tpu_torch.tools.profile_kernels

For B4 (``ba_blocks``) at (O, V) = (262144, 16), (233984, 16) and
(233984, 500) with random camera ids, and for B3 (``match_top2``) at
32768 x 2048 x 128, it prints what ``torch.profiler`` measured for each
CUDA kernel of a wrapper call (mean device time over the repeats, so the
two stages of B4 show apart and launch overhead is left out), the wrapper's
CUDA-event time with a warm L2 and after 64 MB of other traffic, and the
achieved rates against the bytes and operations the function needs. Every
line carries the card's name and power limit.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from structure_from_motion_tpu_torch.ops import ba_cuda, matching

REPS = 30


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
        if dev_us > 0 and ("ba_" in ev.key or "match_top2" in ev.key):
            out[ev.key.split("::")[-1].split("(")[0]] = dev_us / ev.count
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    flush = torch.zeros(16 * 1024 * 1024, dtype=torch.float32, device=dev)

    for O, V in ((262144, 16), (233984, 16), (233984, 500)):
        cam = torch.as_tensor(rng.integers(0, V, O).astype(np.int32)).to(dev)
        f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(dev)  # noqa: E731
        q = f(O, 4) * 0.05
        q[:, 0] += 1.0
        X = f(O, 3)
        X[:, 2] += 10.0
        args = (cam, f(O, 3), q, X, f(O, 2) * 0.1,
                torch.as_tensor((rng.random(O) < 0.3).astype(np.float32)).to(dev), V, 0.01)
        _report(f"B4 ba_blocks O = {O}, V = {V}", lambda: ba_cuda.ba_blocks(*args),
                188 * O + 228 * V, 400 * O, flush, card)

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
