"""Device time of variants of B1, B2, B4, B6 and B7 that are NOT in the tree.

Run on a machine with an NVIDIA card, from the repository root:

    python3 -m structure_from_motion_tpu_torch.tools.kernel_variants [--only b4,b6]

The notes at the head of ``csrc/blur.cu``, ``csrc/cand.cu`` and
``csrc/svd.cu`` and at B6 in ``csrc/ba_matvec.cu`` say what else was
tried; this script is where those times come from. It
builds each variant from the source in the tree with one constant or
statement substituted (a substitution that no longer finds its text
raises), compiles all of a group together with the library's flags into
``build/kernel_variants/``, holds the result against the plain version and
prints the median device time of the kernel under ``torch.profiler``
(``--only``: some of the groups below, by default all):

* ``b1``: B1 with another tile (threads, tile width, tile height, outputs
  a thread in the H- and V-pass, blocks an SM), with or without one block a
  level, at the six shapes a 960x1280 frame launches it at, and five
  levels of one radius beside the five radii;
* ``ablate``: B1's 64 x 128 tile with a part taken out (the result is then
  wrong and is not compared): where its time goes;
* ``b2``: the fused B2 (``candidate_block_max``) with another tile (columns
  a thread, rows a strip) at the five DoG stacks of a rendered 960x1280
  frame, and the tree's tile with a part taken out or changed
  (threads a block, blocks an SM, the Hessian test, the prefetch of the row
  after next, the loads of the row loop);
* ``b4``: B4 with a change to its camera reduction (``ba_reduce_rows``:
  rows in flight, the lane offsets, blocks an SM) at (O, V) = (262144, 16)
  and (233984, 500) and at B = 8 lanes of (262144, 16), the device time of
  each of its two kernels;
* ``b6``: B6 with other block sizes and rows in flight, and the variant
  ``variant_sources/reduce_slot_per_thread.cu``, over the 500-camera stream;
* ``ffma``: the FMA rate of B1's inner code alone
  (``variant_sources/ffma_rate.cu``);
* ``b7``: B7's first design ("cyclic Jacobi",
  ``variant_sources/svd_cyclic_jacobi.cu``: a cyclic Jacobi for every null
  vector, three group sums a pair, tall matrices reduced by 256-row blocks
  in 2-4 launches) against the tree's
  and the tree's with another 12-column Jacobi group or another reduction
  block, at every shape a slice frame launches it at
  (``tools/svd_cases.slice_inputs``): CUDA-event time of one call (warm,
  the host's enqueue kept out) and the device time of every kernel and
  memset of the call, in the order first design, tree, the variants, tree,
  first design;
  each result held to the plain version with the smoke's tolerance, but
  for the tree's tall kernel with a part taken out ("wrong result"): where
  its time goes.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from structure_from_motion_tpu_torch import kernels
from structure_from_motion_tpu_torch.config import FrontendConfig
from structure_from_motion_tpu_torch.ops import ba_cuda, ba_matvec, blur_cuda, features_cuda
from structure_from_motion_tpu_torch.ops import small_svd
from structure_from_motion_tpu_torch.tools import svd_cases
from structure_from_motion_tpu_torch.tools.profile_kernels import (
    ARTIFACT,
    _event_ms,
    b4_inputs,
    device_times,
    frame_dog_stacks,
    frame_kernels,
    frame_shapes,
    global_stream,
)

HERE = Path(__file__).resolve().parent / "variant_sources"
OUT = kernels.BUILD_DIR.parent / "kernel_variants"
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
BLUR_ARGS = [_P, _P, _I, _I, _I, _I, _L, _P, _P]
REDUCE_ARGS = [_P, _P, _P, _P, _I, _I, _I, _P, _P]
BLOCK_MAX_ARGS = [_P, _I, _I, _I, _I, _F, _F, _F, _I, _P, _P, _P]

# B1: template arguments of csrc/blur.cu's launch<NT, TW, TH, NH, NV, MINB>,
# "+split" for one block a level
B1_TILES = [
    "256,64,128,8,8,2", "256,64,120,8,8,2", "256,64,96,8,8,2", "256,64,64,8,8,3",
    "256,32,64,8,8,4", "256,64,32,8,8,4", "256,32,32,8,8,6", "512,64,64,8,8,2",
    "256,64,128,16,8,2", "256,64,128,8,16,2", "256,32,64,4,4,4",
    "256,64,128,8,8,2+split", "256,64,32,8,8,4+split",
]
_H_LOOP = "for (int item = threadIdx.x; item < kHItems; item += NT) {"
_V_LOOP = "for (int item = threadIdx.x; item < kVItems; item += NT) {"
_NEVER = " && H < 0; item += NT) {"  # a condition the compiler cannot fold
# B1 ablations: name -> substitutions on the 64 x 128 variant's source
B1_ABLATIONS = {
    "as in the tree": [],
    "staging by plain loads, each stored before the next": [
        ("copy_async_or_zero(sbase + ry * pb + rx, in ? grow + gx : base, in);",
         "sbase[ry * pb + rx] = in ? __ldg(grow + gx) : 0.f;")],
    "no staging": [("for (int ry = warp; ry < hb; ry += NT / 32) {",
                    "for (int ry = warp; ry < hb && H < 0; ry += NT / 32) {")],
    "no shared loads (inputs made up in registers)": [
        ("const float v = src[j];", "const float v = __int_as_float(__float_as_int(v0) + j);"),
        ("const float v = src[j * kPm];",
         "const float v = __int_as_float(__float_as_int(v0) + j);"),
        ("    float acc[NH];\n", "    float acc[NH];\n    const float v0 = sbase[item];\n"),
        ("    float acc[NV];\n", "    float acc[NV];\n    const float v0 = smid[item];\n")],
    "no barriers between the passes": [
        ("  __syncthreads();\n\n  // V-pass", "\n  // V-pass"),
        ("  __syncthreads();  // smid is free for the next level\n", "")],
    "no H-pass": [(_H_LOOP, _H_LOOP.replace("; item += NT) {", _NEVER))],
    "no V-pass": [(_V_LOOP, _V_LOOP.replace("; item += NT) {", _NEVER))],
    "neither pass (staging and launch alone)": [
        (_H_LOOP, _H_LOOP.replace("; item += NT) {", _NEVER)),
        (_V_LOOP, _V_LOOP.replace("; item += NT) {", _NEVER))],
    "taps in ordinary registers (through shared memory)": [
        ("  for (int t = 0; t <= 2 * R; ++t) k[t] = taps[t];",
         "  for (int t = 0; t <= 2 * R; ++t) k[t] = stap[t];"),
        ("const float* __restrict__ taps, int x0, int y0, int H,",
         "const float* __restrict__ stap, int x0, int y0, int H,"),
        ("  extern __shared__ float smem[];",
         "  extern __shared__ float smem[];\n"
         "  __shared__ float stap_all[kMaxLevels * kMaxTaps];\n"
         "  for (int i = threadIdx.x; i < kMaxLevels * kMaxTaps; i += NT)\n"
         "    stap_all[i] = taps.k[i / kMaxTaps][i % kMaxTaps];"),
        ("smid, taps.k[l], x0", "smid, stap_all + l * kMaxTaps, x0")],
}
# B2 (fused): the tile kC, kR, kU of csrc/cand.cu's launch_block_max<S, C, R, U>
# (columns a thread, rows a strip, row unroll), then optionally "bN": at
# least N blocks an SM
B2_TILES = ["2,8,2", "4,8,1", "4,8,2", "4,8,3", "4,16,1", "4,16,2", "4,16,3", "4,24,3", "4,32,2",
            "2,8,1", "2,8,3", "2,16,2", "2,24,3", "2,8,1,b5", "2,8,2,b5", "2,8,3,b4",
            "2,16,2,b4",
            "1,8,1", "1,8,2", "1,16,2"]
_B2_BOUNDS = "__launch_bounds__(kFusedThreads)\ncandidate_block_max"
_B2_LOOP_LOAD = ("    // in flight while this row is computed\n"
                 "    load_row<S, C>(col, layer_stride, W, min(y + 2, H - 1), nxt);\n")
_B2_LOOP_END = "    copy_row<S, C>(c3, nxt);\n  }\n}"
# B2 changes: name -> substitutions on the tree's source; the ones
# marked "wrong result" are not compared with the plain version
B2_CHANGES = {
    "as in the tree": [],
    "64 threads a block": [("constexpr int kFusedThreads = 128;",
                            "constexpr int kFusedThreads = 64;")],
    "256 threads a block": [("constexpr int kFusedThreads = 128;",
                             "constexpr int kFusedThreads = 256;")],
    "at least 6 blocks an SM (80 registers)": [
        (_B2_BOUNDS, _B2_BOUNDS.replace("kFusedThreads)", "kFusedThreads, 6)"))],
    "no prefetch (the next row loaded after the compute)": [
        (_B2_LOOP_LOAD, ""),
        (_B2_LOOP_END, "    load_row<S, C>(col, layer_stride, W, min(y + 2, H - 1), nxt);\n"
         + _B2_LOOP_END)],
    "no Hessian test (wrong result)": [
        ("if (edge_ok && mag > best[s]) {", "if ((edge_ok || H > 0) && mag > best[s]) {")],
    "no candidate ever passes (wrong result)": [
        ("const bool row_in = y >= border && y < H - border;", "const bool row_in = H < 0;")],
    "no loads in the row loop (wrong result)": [(_B2_LOOP_LOAD, "")],
}
# B6: (threads a camera, rows in flight a warp); "slot:T,K" is the variant file
B6_VARIANTS = ["512,16", "256,16", "128,16", "1024,16", "512,8", "512,32",
               "slot:128,4", "slot:256,2", "slot:128,2"]


# B4: changes to csrc/ba_blocks.cu's camera reduction
_B4_LANE = "  const int lb = kLanes ? blockIdx.y * nb : 0;  // the lane's first block\n"
_B4_ROW = "  const size_t ov = kLanes ? (size_t)blockIdx.y * V + v : (size_t)v;  // the output row\n"
_B4_FLIGHT = "  constexpr int kInFlight = kLanes ? 16 : 4;\n"


def _b4_in_flight(lanes: int, one: int) -> list:
    """The reduction's rows in flight: ``lanes`` in the lane
    instantiation, ``one`` in the one-lane one."""
    return [(_B4_FLIGHT, f"  constexpr int kInFlight = kLanes ? {lanes} : {one};\n")]


B4_CHANGES = {
    "as in the tree": [],
    "lane instantiation with pointer bumps by blockIdx.y": [
        (_B4_LANE, "  const int lb = 0;\n  if (kLanes) {\n"
                   "    rows += (size_t)blockIdx.y * nb * rmax * kP;\n"
                   "    slot += (size_t)blockIdx.y * nb * V;\n"
                   "    U += (size_t)blockIdx.y * V * 49;\n    bc += (size_t)blockIdx.y * V * 7;\n"
                   "    cost += (size_t)blockIdx.y * V * kCostStride;\n  }\n"),
        (_B4_ROW, "  const size_t ov = v;\n")],
    "8 rows in flight in both instantiations": _b4_in_flight(8, 8),
    "lane instantiation with 32 rows in flight": _b4_in_flight(32, 4),
    "one-lane instantiation with 2 rows in flight": _b4_in_flight(16, 2),
    "ba_reduce_rows held to two blocks an SM": [
        ("__global__ void __launch_bounds__(kP * kGroups)\n",
         "__global__ void __launch_bounds__(kP * kGroups, 2)\n")],
}
BA_BLOCKS_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P]
SVD_ARGS = [_P, _I, _I, _I, _I, _P, _L, _P, _P, _P, _P]
# B7: changes to csrc/svd.cu (the tree's reduction blocks take 256 threads
# x 4 rows of a matrix they share, x 8 of one they take alone; its 9- and
# 12-column Jacobi groups 16 lanes, a row a lane)
_B7_FIRST = "cyclic Jacobi (the first design)"
_B7_ROWS = "constexpr int kRowsPerThread = 4;"
_B7_THREADS = "constexpr int kTallThreads = 256;"
B7_CHANGES = {
    "12-column Jacobi: 8 lanes, two rows a lane": [
        ("constexpr int kLanes12 = 16;", "constexpr int kLanes12 = 8;")],
    "12-column Jacobi: 4 lanes, three rows a lane": [
        ("constexpr int kLanes12 = 16;", "constexpr int kLanes12 = 4;")],
    "9-column Jacobi: 8 lanes, two rows a lane": [
        ("constexpr int kLanes9 = 16;", "constexpr int kLanes9 = 8;")],
    "9-column Jacobi: 4 lanes, three rows a lane": [
        ("constexpr int kLanes9 = 16;", "constexpr int kLanes9 = 4;")],
    "Jacobi: t by zeta = (beta - alpha) / 2 gamma (three approximate roots and quotients)": [
        ("  const float d = beta - alpha, e = 2.0f * gamma;\n"
         "  const float h2 = fmaf(d, d, e * e);\n"
         "  return __fdividef(copysignf(1.0f, d) * e, fabsf(d) + h2 * rsqrtf(h2));\n",
         "  const float zeta = __fdividef(beta - alpha, 2.0f * gamma);\n"
         "  const float r = fmaf(zeta, zeta, 1.0f);\n"
         "  const float t = __fdividef(copysignf(1.0f, zeta), fabsf(zeta) + r * rsqrtf(r));\n"
         "  return fabsf(zeta) > 1.0e15f ? __fdividef(0.5f, zeta) : t;\n")],
    "Jacobi: one round's code, run in a loop": [
        ("#pragma unroll\n    for (int round = 0;", "#pragma unroll 1\n    for (int round = 0;")],
    "Jacobi: every lane works out every rotation": [
        ("constexpr int kSpreadPairs = 3;", "constexpr int kSpreadPairs = 99;")],
    "Jacobi: the 4 x 4 rotations spread over the lanes too": [
        ("constexpr int kSpreadPairs = 3;", "constexpr int kSpreadPairs = 2;")],
    "shared matrices in blocks of 256 x 2 rows": [(_B7_ROWS, "constexpr int kRowsPerThread = 2;")],
    "shared matrices in blocks of 256 x 8 rows": [(_B7_ROWS, "constexpr int kRowsPerThread = 8;")],
    "one block a matrix up to 256 x 4 rows": [("constexpr int kRowsOne = 8;",
                                               "constexpr int kRowsOne = 4;")],
    "one block a matrix up to 256 x 16 rows": [("constexpr int kRowsOne = 8;",
                                                "constexpr int kRowsOne = 16;")],
    "reduction blocks of 128 threads": [(_B7_THREADS, "constexpr int kTallThreads = 128;")],
    "reduction blocks of 512 threads": [(_B7_THREADS, "constexpr int kTallThreads = 512;")],
    "wide: reflectors normalised by the approximate rsqrtf": [
        ("    const float inv = half_utu > 0.0f ? 1.0f / sqrtf(2.0f * half_utu) : 0.0f;",
         "    const float inv = half_utu > 0.0f ? rsqrtf(2.0f * half_utu) : 0.0f;")],
    "wide matrices by the Jacobi too": [
        ("  if (M < N) {\n    null_wide<N>", "  if (M < N && M < 0) {\n    null_wide<N>")],
    "tall: no final Jacobi (wrong result)": [
        ("  jacobi_null<N, Gr::G, Gr::R>(b, N, t, group_mask<Gr::G>(t), out + m * N);",
         "  if (t < N) out[m * N + t] = b[0][0];")],
    "tall: no QR of the stacked R's (wrong result)": [
        ("      block_qr<N, T, RPT>(a, (first + count + T - 1) / T, part, total, pivot);\n", "")],
}


def _substitute(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"kernel_variants: the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def blur_source(tile: str, pairs=()) -> str:
    """``csrc/blur.cu`` with its choice of tile replaced by ``tile``."""
    src = (kernels.CSRC / "blur.cu").read_text()
    cfg, _, split = tile.partition("+")
    a = src.index("  cudaError_t rc;\n  if (tiles(64, 128)")
    b = src.index("  return static_cast<int>(rc);")
    forced = (f"  cudaError_t rc = launch<{cfg}>(base, taps, L, lanes, halo, H, W, out, "
              f"out_lane, {'L > 1' if split else 'false'}, s);\n")
    return _substitute(src[:a] + forced + src[b:], pairs)


def cand_source(tile: str, pairs=()) -> str:
    """``csrc/cand.cu`` with every shape sent to the tile ``tile`` =
    "C,R,U[,bN]"."""
    src = (kernels.CSRC / "cand.cu").read_text()
    parts = tile.replace(" ", "").split(",")
    tile, pairs = ",".join(parts[:3]), list(pairs)
    for o in parts[3:]:
        pairs.append((_B2_BOUNDS, _B2_BOUNDS.replace("kFusedThreads)", f"kFusedThreads, {o[1:]})")))
    c, r, u = tile.split(",")
    return _substitute(src, [("constexpr int kC = 2, kR = 8, kU = 2;",
                              f"constexpr int kC = {c}, kR = {r}, kU = {u};")] + pairs)


def reduce_source(variant: str) -> str:
    if variant.startswith("slot:"):
        t, k = variant[5:].split(",")
        return _substitute((HERE / "reduce_slot_per_thread.cu").read_text(), [
            ("constexpr int kT = 128;", f"constexpr int kT = {t};"),
            ("constexpr int kK = 4;", f"constexpr int kK = {k};")])
    t, b = variant.split(",")
    pairs = [("constexpr int kReduceThreads = 512;", f"constexpr int kReduceThreads = {t};"),
             ("constexpr int kReduceBatch = 16;", f"constexpr int kReduceBatch = {b};")]
    if b == "32":
        pairs.append(("(1u << kReduceBatch) - 1u", "0xffffffffu"))
    return _substitute((kernels.CSRC / "ba_matvec.cu").read_text(), pairs)


def build(group: str, sources: dict, entry: str, argtypes: list) -> dict:
    """Compile ``{name: source text}`` together; ``{name: loaded library}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = []
    for i, (name, text) in enumerate(sources.items()):
        cu, so = OUT / f"{group}_{i}.cu", OUT / f"{group}_{i}.so"
        cu.write_text(text)
        procs.append((name, so, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        regs = kernels.ptxas_registers(log)
        print(f"built {group} [{name}]: registers (spill stores, bytes) "
              + ", ".join(f"{k} {r} ({sp})" for k, (r, sp) in regs.items()))
        lib = ctypes.CDLL(str(so))
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = _I
        libs[name] = lib
    return libs


def device_us(fn, key: str, reps: int = 20) -> float:
    """Median device microseconds of the kernels named ``*key*`` over
    ``reps`` calls of ``fn``, each after a short spin of the card. After
    some hundred traces in one process a trace now and then comes back
    without device records: it is taken again, three times at most."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                torch.cuda._sleep(200_000)
                fn()
            torch.cuda.synchronize()
        times = [t for ev in prof.events() if key in ev.name
                 for t in [getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)]
                 if t > 0]
        if times:
            return float(np.median(times))
    raise RuntimeError(f"the profiler saw no kernel named *{key}*")


def _time_blur(libs: dict, shapes, dev, rng, card: str, check: bool) -> None:
    stream = kernels.stream_ptr(dev)
    for label, (h, w), ks in shapes:
        img = torch.as_tensor(rng.random((h, w)).astype(np.float32)).to(dev)
        out = torch.empty((len(ks), h, w), device=dev)
        ref = blur_cuda.blur_levels_reference(img, ks)
        table = blur_cuda.taps_table(ks)
        for name, lib in libs.items():
            def call():
                return lib.sfm_blur_levels_lanes(img.data_ptr(), ctypes.byref(table), len(ks), 1,
                                                 h, w, len(ks) * h * w, out.data_ptr(), stream)
            out.zero_()
            kernels.check(call(), f"variant {name}")
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if check and not err <= 2e-5:
                raise AssertionError(f"B1 variant {name} at {label}: max_abs_err {err:.2e}")
            print(f"B1 {label} {h}x{w} [{name}]: {device_us(call, 'blur_'):.1f} us"
                  + (f", max_abs_err {err:.1e}" if check else "") + f" ({card})")


def b1_tiles(dev, rng, card) -> None:
    rel, _ = frame_kernels()
    libs = build("b1", {t: blur_source(t) for t in B1_TILES}, "sfm_blur_levels_lanes", BLUR_ARGS)
    shapes = frame_shapes() + [("octave 0, radius 9 five times", (1920, 2560), [rel[2]] * 5),
                               ("octave 4, radius 9 five times", (120, 160), [rel[2]] * 5)]
    _time_blur(libs, shapes, dev, rng, card, check=True)


def b1_ablations(dev, rng, card) -> None:
    rel, base_k = frame_kernels()
    libs = build("ablate", {n: blur_source("256,64,128,8,8,2", p) for n, p in B1_ABLATIONS.items()},
                 "sfm_blur_levels_lanes", BLUR_ARGS)
    shapes = [("octave 0", (1920, 2560), rel), ("radius 15 alone", (1920, 2560), [rel[4]]),
              ("base blur", (1920, 2560), base_k)]
    _time_blur(libs, shapes, dev, rng, card, check=False)


def _time_block_max(libs: dict, stacks, dev, card: str, check) -> None:
    fe = FrontendConfig()
    args = (fe.contrast_threshold, fe.edge_threshold, 8)
    stream = kernels.stream_ptr(dev)
    for dog in stacks:
        S2, h, w = dog.shape
        ref = features_cuda.candidate_block_max_reference(dog, *args)
        cand = torch.empty_like(ref[0])
        pos = torch.empty_like(ref[1])
        for name, lib in libs.items():
            def call():
                return lib.sfm_candidate_block_max_lanes(
                    dog.data_ptr(), 1, S2 - 2, h, w, args[0], args[1], (args[1] + 1.0) ** 2, args[2],
                    cand.data_ptr(), pos.data_ptr(), stream)
            cand.zero_()
            kernels.check(call(), f"variant {name}")
            torch.cuda.synchronize()
            same = torch.equal(cand, ref[0]) and torch.equal(pos, ref[1])
            if check(name) and not same:
                raise AssertionError(f"B2 variant {name} at {h}x{w} differs from the plain version")
            print(f"B2 fused ({S2}, {h}, {w}) [{name}]: "
                  f"{device_us(call, 'candidate_block_max'):.1f} us"
                  + (", equal to the plain version" if same else ", NOT equal") + f" ({card})")


def b2_variants(dev, card) -> None:
    stacks = frame_dog_stacks(dev)
    libs = build("b2", {t: cand_source(t) for t in B2_TILES}, "sfm_candidate_block_max_lanes",
                 BLOCK_MAX_ARGS)
    _time_block_max(libs, stacks, dev, card, lambda name: True)
    libs = build("b2c", {n: cand_source("2,8,2", p) for n, p in B2_CHANGES.items()},
                 "sfm_candidate_block_max_lanes", BLOCK_MAX_ARGS)
    _time_block_max(libs, stacks, dev, card, lambda name: "wrong result" not in name)


def b4_source(pairs) -> str:
    return _substitute((kernels.CSRC / "ba_blocks.cu").read_text(), pairs)


def b4_variants(dev, rng, card) -> None:
    """Each variant at one lane and at B = 8 lanes, its outputs bit for bit
    the tree's; the device time of each kernel (the lane launch's
    reduction is ``ba_reduce_rows<true>``)."""
    libs = build("b4", {n: b4_source(p) for n, p in B4_CHANGES.items()}, "sfm_ba_blocks_lanes",
                 BA_BLOCKS_ARGS)
    stream = kernels.stream_ptr(dev)
    for B, O, V in ((0, 262144, 16), (0, 233984, 500), (8, 262144, 16)):
        bargs = b4_inputs(dev, rng, O, V, B)
        want = ba_cuda.ba_blocks(*bargs)
        n = max(B, 1)
        lead = (B,) if B else ()
        nb = -(-O // ba_cuda._BLOCK)
        n_rows = n * nb * min(ba_cuda._BLOCK, V) * ba_cuda._ROW
        f32 = lambda *s: torch.empty(lead + s, dtype=torch.float32, device=dev)  # noqa: E731
        outs = (f32(V, 7, 7), f32(V, 7), f32(O, 3, 3), f32(O, 7, 3), f32(O, 3))
        cost = f32(V, 2)
        scratch = torch.empty(n_rows + -(-n * V * nb // 4), dtype=torch.float32, device=dev)
        for name, lib in libs.items():
            def call():
                U, bc, dtd, wblk, bp = (t.data_ptr() for t in outs)
                return lib.sfm_ba_blocks_lanes(
                    *(t.data_ptr() for t in bargs[:6]), n, O, V, bargs[7], dtd, wblk, bp,
                    scratch.data_ptr(), scratch.data_ptr() + 4 * n_rows, U, bc,
                    cost.data_ptr(), stream)
            kernels.check(call(), f"variant {name}")
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip((*outs, cost[..., 0].sum(-1)), want))
            if not same:
                raise AssertionError(f"B4 variant {name} differs from the tree's kernel")
            reduce = "ba_reduce_rows<true>" if B else "ba_reduce_rows<false>"
            print(f"B4 O = {O}, V = {V}{f', {B} lanes' if B else ''} [{name}]: ba_assemble "
                  f"{device_us(call, 'ba_assemble'):.2f} us, {reduce} "
                  f"{device_us(call, reduce):.2f} us, the tree's bits ({card})")


def b6_variants(dev, rng, card, artifact: str) -> None:
    libs = build("b6", {v: reduce_source(v) for v in B6_VARIANTS}, "sfm_reduce_cam", REDUCE_ARGS)
    w21, y, perm, mask, O, V, cam_rows, _ = global_stream(dev, rng, artifact)
    ref = ba_matvec.reduce_cam_reference(w21, y, perm, mask, V)
    bound = 1e-4 * max(1.0, float(ref.abs().max()))
    coup = torch.empty((V, 7), device=dev)
    stream = kernels.stream_ptr(dev)
    for name, lib in libs.items():
        def call():
            return lib.sfm_reduce_cam(w21.data_ptr(), y.data_ptr(), perm.data_ptr(),
                                      mask.data_ptr(), O, V, cam_rows, coup.data_ptr(), stream)
        coup.zero_()
        kernels.check(call(), f"variant {name}")
        torch.cuda.synchronize()
        err = float((coup - ref).abs().max())
        if not err <= bound:
            raise AssertionError(f"B6 variant {name}: max_abs_err {err:.2e} over {bound:.2e}")
        print(f"B6 {V} cameras x {cam_rows} slots [{name}]: {device_us(call, 'reduce_'):.2f} us, "
              f"max_abs_err {err:.1e} ({card})")


def ffma_rate(dev, card) -> None:
    lib = build("ffma", {"ffma_rate": (HERE / "ffma_rate.cu").read_text()}, "sfm_ffma_rate",
                [_I, _I, _I, _P, _P])["ffma_rate"]
    out = torch.zeros(4, device=dev)
    stream = kernels.stream_ptr(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    for which, K, rep in ((0, 31, 1), (3, 31, 4), (1, 31, 16), (2, 9, 1)):
        for blocks_per_sm in (2, 8):
            blocks, n = sms * blocks_per_sm, 1600 // rep

            def call():
                return lib.sfm_ffma_rate(which, blocks, n, out.data_ptr(), stream)
            kernels.check(call(), "ffma_rate")
            us = device_us(call, "ffma_rate", reps=5)
            warp_fmas = blocks * 8 * n * rep * K * 8
            code_kb = rep * K * 8 * 16 / 1024
            print(f"FMA rate, {K} taps x 8 outputs, {rep} copies in a row ({code_kb:.0f} KB of "
                  f"code), {blocks_per_sm} blocks of 8 warps an SM: {us:.0f} us, "
                  f"{warp_fmas / (us * 1e-6) / sms / clock_hz:.2f} of 4 warp FMAs a clock an SM "
                  f"at {clock_hz / 1e6:.0f} MHz ({card})")


def svd_source(pairs) -> str:
    return _substitute((kernels.CSRC / "svd.cu").read_text(), pairs)


def b7_variants(dev, card) -> None:
    """B7's first design, the tree's and its variants at every slice shape; each
    call's outputs held to the plain version (null vectors: the smoke's
    tolerance, ``svd_cases.null_vector_error``; the 3 x 3 factors to 1e-3
    and rebuilding A)."""
    sources = {_B7_FIRST: (HERE / "svd_cyclic_jacobi.cu").read_text(),
               "as in the tree": svd_source([])}
    sources.update((n, svd_source(p)) for n, p in B7_CHANGES.items())
    libs = build("b7", sources, "sfm_small_svd", SVD_ARGS)
    order = [_B7_FIRST, "as in the tree", *B7_CHANGES, "as in the tree", _B7_FIRST]
    stream = kernels.stream_ptr(dev)
    for (batch, M, N, full), arr in svd_cases.slice_inputs().items():
        A = torch.as_tensor(arr).to(dev).contiguous()
        ref = small_svd.small_svd_reference(A, not full)
        U = torch.empty((batch, 3, 3), device=dev)
        S = torch.empty((batch, 3), device=dev)
        V = torch.empty((batch, 3, 3) if full else (batch, N), device=dev)
        # room for the first design's two halves (256-row blocks) and every variant's
        floats = 2 * batch * -(-M // 256) * N * N + batch
        scratch = torch.empty(floats, device=dev)
        for name in order:
            lib = libs[name]
            # the first design's entry takes the floats of each of its two halves
            given = floats // 2 if name == _B7_FIRST else floats

            def call():
                return lib.sfm_small_svd(A.data_ptr(), batch, M, N, int(full), scratch.data_ptr(),
                                         given, U.data_ptr(), S.data_ptr(), V.data_ptr(), stream)
            V.zero_()
            kernels.check(call(), f"B7 variant {name}")
            torch.cuda.synchronize()
            if full:
                rebuilt = float(((U * S[..., None, :]) @ V - A).abs().max())
                ok = rebuilt <= 1e-4 * float(ref[1].max())
                held = f"U S Vh - A {rebuilt:.1e}"
            else:
                err, _, unit, slack = svd_cases.null_vector_error(A, V, ref[2][..., 0, :])
                ok = err <= 1e-3 and unit <= 1e-5 and slack <= 0 and bool(V.isfinite().all())
                held = f"max_abs_err {err:.1e}, slack {slack:.1e}"
            if not ok and "wrong result" not in name:
                raise AssertionError(f"B7 variant {name} at {batch} x {M} x {N}: {held}")
            for _ in range(3):  # a trace now and then comes back without device records
                parts = device_times(call, every=True)
                if parts:
                    break
            print(f"B7 {batch} x {M} x {N}{' U S Vh' if full else ''} [{name}]: "
                  f"{_event_ms(call):.4f} ms by events, device {sum(parts.values()):.2f} us ("
                  + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + f"), {held} ({card})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="b1,ablate,b2,b4,b6,ffma,b7")
    ap.add_argument("--artifact", default=str(ARTIFACT), help="checkpoint whose stream B6 walks")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    if "b1" in only:
        b1_tiles(dev, rng, card)
    if "ablate" in only:
        b1_ablations(dev, rng, card)
    if "b2" in only:
        b2_variants(dev, card)
    if "b4" in only:
        b4_variants(dev, rng, card)
    if "b6" in only:
        b6_variants(dev, rng, card, args.artifact)
    if "ffma" in only:
        ffma_rate(dev, card)
    if "b7" in only:
        b7_variants(dev, card)


if __name__ == "__main__":
    main()
