"""Device time of the kernels B1 to B6, kernel by kernel.

Run on a machine with an NVIDIA card, from the repository root:

    python3 -m structure_from_motion_tpu_torch.tools.profile_kernels [--only B1,B2,B6]

For B1 (``blur_levels``) at the six shapes a 960x1280 frame launches it at
(the base blur, 1920x2560 with one level of radius 4, then the five levels
of the default sigmas at the octaves from 1920x2560 down to 120x160) and
the six of a 600x800 frame (1200x1600 down to 75x100); for
B4 (``ba_blocks``) at (O, V) = (262144, 16), (233984, 16) and (233984, 500)
with random camera ids; for B3 (``match_top2``) at 32768 x 2048 x 128; for
B2 over the five DoG stacks of a rendered 960x1280 frame (the kernel that
writes the response map, the fused ``candidate_block_max`` where the
version under test has it; the map kernel also over the five stacks of a
600x800 frame, 1200x1600 down to 75x100; and at octave 0 the whole candidate stage: the
map kernel followed by the four reductions that used to keep one candidate
a block, against the fused kernel alone); and for B5 (``expand_cam``) and
B6 (``reduce_cam``) over
the camera-major view of the 500-camera checkpoint's stream (``--artifact``,
by default ``artifacts/longrun500_pre_globalba.ckpt.npz``), it prints what
``torch.profiler`` measured for each CUDA kernel of a wrapper call (mean
device time over the repeats, so the stages of a wrapper show apart and
launch overhead is left out), the wrapper's CUDA-event time with a warm L2
and after 64 MB of other traffic, and the achieved rates against the bytes
and operations the function needs. For B4 it also splits the wrapper's
event time: the host's enqueue time of a call (and of the ``sfm::``
operator alone), the event time after a spin ten times as long, and the
device time of every kernel the call launches. Every line carries the
card's name and power limit.

It calls only the wrappers, so the same file runs against another version
of the kernels: copy it over that version's ``tools/profile_kernels.py``
and run it from that checkout, within one run on one card.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from structure_from_motion_tpu_torch.config import FrontendConfig
from structure_from_motion_tpu_torch.models import global_ba
from structure_from_motion_tpu_torch.ops import ba, ba_cuda, ba_matvec, blur_cuda
from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence
from structure_from_motion_tpu_torch.ops import features, features_cuda, matching
from structure_from_motion_tpu_torch.utils import checkpoint

REPS = 30
ARTIFACT = Path(__file__).resolve().parents[2] / "artifacts" / "longrun500_pre_globalba.ckpt.npz"
_KERNEL_NAMES = ("ba_", "match_top2", "blur_", "reduce_cam", "expand_cam", "candidate_")


def _event_ms(fn, flush=None, spin: int = 500_000) -> float:
    """Median time between two CUDA events around one wrapper call. The card
    first spins ``spin`` cycles (~0.3 ms by default; after the optional
    flush) so that the host has enqueued the call before the first event
    fires: device time, not the host's enqueue time, as long as the
    enqueue takes less than the spin."""
    times = []
    for _ in range(REPS):
        if flush is not None:
            flush.add_(1.0)
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_times(fn, every: bool = False) -> dict:
    """Mean device microseconds a call, by kernel name: the kernels of B1-B6
    (``every``: every kernel the call launches)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
        # kernels only: the sfm:: operator's host event carries its kernels'
        # device time as well
        kernel = ev.device_type == torch.autograd.DeviceType.CUDA and (
            every or any(k in ev.key for k in _KERNEL_NAMES))
        if dev_us > 0 and kernel:
            name = ev.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            out[name.split("(")[0][:60]] = dev_us / (ev.count if not every else REPS)
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


def _host_us(fn) -> float:
    """Mean host microseconds to enqueue one call (no synchronisation)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    host = (time.perf_counter() - t0) / REPS * 1e6
    torch.cuda.synchronize()
    return host


def _wrapper_split(name, fn, op, card) -> None:
    """Where a wrapper's event time goes: the host's enqueue time of the
    wrapper and of its ``sfm::`` operator alone, the event time with the
    usual spin and with a spin ten times as long, and the device time of
    every kernel the call launches (the copies and reductions around the
    kernel included)."""
    for _ in range(3):
        fn()
    host, op_host = _host_us(fn), _host_us(op)
    short, long_ = _event_ms(fn), _event_ms(fn, spin=5_000_000)
    parts = _device_times(fn, every=True)
    print(f"{name} wrapper: host enqueue {host:.1f} us a call ({op_host:.1f} us through the "
          f"operator alone); event time {short:.4f} ms after a 0.3 ms spin, {long_:.4f} ms after "
          f"a 3 ms spin; device time of every kernel of the call (us): "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
          + f"; sum {sum(parts.values()):.2f} us ({card})")


def b4_inputs(dev, rng, O: int, V: int) -> tuple:
    """B4's arguments: O observations with random camera ids in [0, V)."""
    cam = torch.as_tensor(rng.integers(0, V, O).astype(np.int32)).to(dev)
    f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(dev)  # noqa: E731
    q = f(O, 4) * 0.05
    q[:, 0] += 1.0
    X = f(O, 3)
    X[:, 2] += 10.0
    return (cam, f(O, 3), q, X, f(O, 2) * 0.1,
            torch.as_tensor((rng.random(O) < 0.3).astype(np.float32)).to(dev), V, 0.01)


def frame_kernels():
    """The taps a frame blurs with at the default sigmas: the five relative
    kernels of an octave (radii 4, 6, 9, 12, 15) and the base blur's one."""
    fe = FrontendConfig()
    S = fe.scales_per_octave
    sig = [fe.sigma0 * 2.0 ** (i / S) for i in range(S + 3)]
    rel = [features._gaussian_kernel1d(math.sqrt(s**2 - sig[0] ** 2)) for s in sig[1:]]
    return rel, [features._gaussian_kernel1d(math.sqrt(fe.sigma0**2 - 1.0))]


def frame_shapes(size=(960, 1280)):
    """(label, (H, W), taps) of B1's six launches on a frame of ``size``
    (2x first octave, five octaves, each half the one before, rounded up)."""
    rel, base_k = frame_kernels()
    h, w = 2 * size[0], 2 * size[1]
    shapes = [("base blur", (h, w), base_k)]
    for o in range(5):
        shapes.append((f"octave {o}", (h, w), rel))
        h, w = (h + 1) // 2, (w + 1) // 2
    return shapes


def global_stream(dev, rng, artifact: str):
    """B5's and B6's inputs over the checkpoint's tiered stream, W and y
    random: (w21, y, perm, mask, O, V, rows, cam)."""
    state, frame, archive, _ = checkpoint.load_state(artifact, dev)
    prob = global_ba.build_global_problem(state, archive, min(frame, 8))
    st, obs, _, _, cam_rows = global_ba.tiered_problem(prob)
    O, V = obs.cam.shape[0], st.C.shape[0]
    w21 = torch.as_tensor(rng.normal(size=(O, 21)).astype(np.float32)).to(dev)
    y = torch.as_tensor(rng.normal(size=(O, 3)).astype(np.float32)).to(dev)
    perm, mask = ba.compute_cam_ell(obs.cam.contiguous(), obs.valid, V, cam_rows)
    return w21, y, perm, mask, O, V, cam_rows, obs.cam.contiguous()


def frame_dog_stacks(dev, size=(960, 1280)) -> list:
    """The five (5, H, W) DoG stacks of a rendered frame of ``size`` at the
    command line's default frontend config (2x first octave, 5 octaves),
    octave 0 (twice ``size``) first."""
    fe = FrontendConfig()
    rel, base_k = frame_kernels()
    img = torch.as_tensor(synthetic_scene_sequence(1, size, seed=3)[0][0]).to(dev)
    img = img.to(torch.float32) / img.max()
    base = blur_cuda.blur_levels(features._upsample2x(img).contiguous(), base_k)[0]
    stacks = []
    for _ in range(5):
        gauss = torch.cat([base[None], blur_cuda.blur_levels(base.contiguous(), rel)])
        stacks.append((gauss[1:] - gauss[:-1]).contiguous())
        base = features._downsample2(gauss[fe.scales_per_octave])
    return stacks


def block_reductions(resp, B: int = 8):
    """The four single-axis reductions that kept one candidate a block
    before the block argmax moved into the kernel."""
    S, h, w = resp.shape
    r4 = resp.reshape(S, h, w // B, B)
    ax1 = torch.argmax(r4, dim=3)
    r5 = r4.amax(dim=3).reshape(S, h // B, B, w // B)
    return r5.amax(dim=2), ax1, torch.argmax(r5, dim=2)

def _b1_cases(dev, rng, card, flush) -> None:
    # a 600x800 frame's shapes too: 8 does not divide its deeper octaves
    for label, (h, w), ks in frame_shapes() + frame_shapes((600, 800)):
        img = torch.as_tensor(rng.random((h, w)).astype(np.float32)).to(dev)
        _report(f"B1 blur_levels {label}: {h}x{w}, radii {[len(k) // 2 for k in ks]}",
                lambda: blur_cuda.blur_levels(img, ks), 4 * h * w * (1 + len(ks)),
                sum(2 * 2 * len(k) for k in ks) * h * w, flush, card)


def _b2_cases(dev, card, flush) -> None:
    fe = FrontendConfig()
    args = (fe.contrast_threshold, fe.edge_threshold, 8)
    fused = getattr(features_cuda, "candidate_block_max", None)
    for dog in frame_dog_stacks(dev):
        S2, h, w = dog.shape
        n_in, n_map = 4 * dog.numel(), 4 * (S2 - 2) * h * w
        ops = 40 * (S2 - 2) * h * w
        _report(f"B2 candidate_response (the map) ({S2}, {h}, {w})",
                lambda: features_cuda.candidate_response(dog, *args), n_in + n_map, ops, flush,
                card)
        if fused is not None:
            _report(f"B2 candidate_block_max (fused) ({S2}, {h}, {w})", lambda: fused(dog, *args),
                    n_in + 8 * (S2 - 2) * (h // 8) * (w // 8), ops, flush, card)
    # the map kernel alone over a 600x800 frame's stacks (topk_block <= 1
    # sends every octave to it; 8 does not divide 300x400 and below)
    for dog in frame_dog_stacks(dev, (600, 800)):
        S2, h, w = dog.shape
        _report(f"B2 candidate_response (the map) ({S2}, {h}, {w})",
                lambda: features_cuda.candidate_response(dog, *args),
                4 * dog.numel() + 4 * (S2 - 2) * h * w, 40 * (S2 - 2) * h * w, flush, card)
    dog = frame_dog_stacks(dev)[0]
    old_ms = _event_ms(lambda: block_reductions(features_cuda.candidate_response(dog, *args)))
    line = (f"B2 candidate stage at {tuple(dog.shape)}: map kernel + four reductions "
            f"{old_ms:.4f} ms by events")
    if fused is not None:
        line += f", fused kernel {_event_ms(lambda: fused(dog, *args)):.4f} ms"
    print(f"{line} ({card})")


def _b5_b6_cases(dev, rng, card, flush, artifact: str, only) -> None:
    w21, y, perm, mask, O, V, cam_rows, cam = global_stream(dev, rng, artifact)
    if "B5" in only:
        x = torch.as_tensor(rng.normal(size=(V, 7)).astype(np.float32)).to(dev)
        _report(f"B5 expand_cam O = {O}, V = {V}", lambda: ba_matvec.expand_cam(cam, w21, x),
                O * (4 + 84 + 12) + 28 * V, 2 * 21 * O, flush, card)
    if "B6" not in only:
        return
    filled = int(mask.sum())
    # the function reads the W and y rows of the filled slots only
    _report(f"B6 reduce_cam {V} cameras x {cam_rows} slots, {filled} filled, O = {O}",
            lambda: ba_matvec.reduce_cam(w21, y, perm, mask, V),
            filled * (84 + 12) + perm.numel() * 5 + 28 * V, 2 * 21 * filled, flush, card)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="B1,B2,B3,B4,B5,B6", help="kernels to time, e.g. B1,B6")
    ap.add_argument("--artifact", default=str(ARTIFACT),
                    help="checkpoint whose stream B5 and B6 walk")
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
    if "B2" in only:
        _b2_cases(dev, card, flush)
    if only & {"B5", "B6"}:
        _b5_b6_cases(dev, rng, card, flush, args.artifact, only)

    for O, V in ((262144, 16), (233984, 16), (233984, 500)) if "B4" in only else ():
        bargs = b4_inputs(dev, rng, O, V)
        _report(f"B4 ba_blocks O = {O}, V = {V}", lambda: ba_cuda.ba_blocks(*bargs),
                188 * O + 228 * V, 400 * O, flush, card)
        if hasattr(ba_cuda, "_ba_blocks_op"):  # the sfm:: operator (a version without skips)
            _wrapper_split(f"B4 ba_blocks O = {O}, V = {V}", lambda: ba_cuda.ba_blocks(*bargs),
                           lambda: torch.ops.sfm.ba_blocks.default(*bargs), card)

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
