"""Build and load the hand-written Hopper kernels under ``csrc/``.

All ``csrc/*.cu`` sources compile with ``nvcc`` (one process per source, all
started together, then one link) into ONE shared library with a plain C
interface, ``build/torch_kernels/libsfm_kernels_<hash>.so`` at the
repository root, named by a hash of the sources and flags so an edited
kernel never loads a stale build. What ``ptxas -v`` said of each kernel
(registers, shared memory, spills) is kept beside it in ``<name>.log``. No
source includes PyTorch's or CUTLASS's headers, so a build takes seconds. It is loaded with ``ctypes``: pointers and
the CUDA stream pass as ``c_void_p``, every entry point returns
``cudaGetLastError()`` and :func:`check` raises when that is not 0.

Each entry point is wrapped as one ``torch.library`` operator in the
``sfm`` namespace (``sfm::blur_levels``, ``candidate_response``,
``candidate_block_max``, ``match_top2``, ``ba_blocks``, ``expand_cam``,
``reduce_cam``, ``cam_diag``, ``small_svd``), registered by its wrapper
module under ``ops/`` (:func:`register_ops` imports them all): the plain version is its CPU
implementation, the ``ctypes`` launch its CUDA implementation, and a fake
implementation gives its output shapes, so ``torch.export`` traces a
program through it. On any other device an operator raises. The entry
points of ``csrc/graph_cond.cu`` are no operators: they add conditional
nodes to a CUDA graph being captured (``utils/control.py`` calls them).

The build runs at the first launch of any kernel (never at import, nor when
an operator is registered: the CPU tests import every module on a machine
without ``nvcc``). There is no fallback: a missing ``nvcc`` or a failed
build raises. :data:`BUILD_DIR` may be pointed elsewhere for the process
(``serve.enable_compilation_cache``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

OPS = ("blur_cuda", "features_cuda", "matching", "ba_cuda", "ba_matvec", "small_svd")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# entry point -> argtypes (all return int = cudaError_t)
_SIGNATURES = {
    # Every kernel with a lane axis takes the lane count; one lane is the
    # call without a lane axis.
    # base, taps (a host BlurTaps), L, lanes, H, W, out_lane (floats), out, stream
    "sfm_blur_levels_lanes": (_P, _P, _I, _I, _I, _I, _L, _P, _P),
    # dog, lanes, S, H, W, contrast, edge_r, (edge_r + 1)^2, border, out, stream
    "sfm_candidate_response_lanes": (_P, _I, _I, _I, _I, _F, _F, _F, _I, _P, _P),
    # dog, lanes, S, H, W, contrast, edge_r, (edge_r + 1)^2, border, cand, pos, stream
    "sfm_candidate_block_max_lanes": (_P, _I, _I, _I, _I, _F, _F, _F, _I, _P, _P, _P),
    # ref, que, sqq, mask_que, lanes, Nr, Nq, d1, d2, j1, stream
    "sfm_match_top2_lanes": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    # cam, C, q, X, uv, w, K (f, k1, k2 an observation, or null), lanes, O, V,
    # huber, dtd, wblk, bp, rows, slot, U, bc, cost, stream
    "sfm_ba_blocks_lanes": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P),
    # w21, y, perm, mask, O, V, rows, coup, stream
    "sfm_reduce_cam": (_P, _P, _P, _P, _I, _I, _I, _P, _P),
    # cam, w, x, O, V, width (7 or 10), t, stream
    "sfm_expand_cam_w": (_P, _P, _P, _I, _I, _I, _P, _P),
    # w, y, perm, mask, seg (or null), O, V, rows, width, coup, stream
    "sfm_reduce_cam_w": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # w, dinv, point, perm, mask, seg (or null), O, M, V, rows, width, parts,
    # part_out (or null), out, stream
    "sfm_cam_diag_w": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # A, batch, M, N, full, scratch, scratch floats, U, S, V, stream
    "sfm_small_svd": (_P, _I, _I, _I, _I, _P, _L, _P, _P, _P, _P),
    # csrc/graph_cond.cu: stream, body stream, predicate; body stream, address of the
    # body's graph; graph, node count (int64 address); graph, 16 int64 counts;
    # address of the new stream
    "sfm_capture_if": (_P, _P, _P),
    "sfm_end_capture": (_P, _P),
    "sfm_graph_nodes": (_P, _P),
    "sfm_graph_node_types": (_P, _P),
    "sfm_stream_create": (_P,),
    # stream, body stream, handle (uint64 address); body stream, handle, active flag,
    # step counter, cap, address of the body's graph
    "sfm_begin_while": (_P, _P, _P),
    "sfm_end_while": (_P, ctypes.c_ulonglong, _P, _P, _L, _P),
}


def register_ops() -> None:
    """Register every ``sfm::*`` operator (import its wrapper module); a
    program exported with them loads only after this. Builds nothing."""
    for name in OPS:
        importlib.import_module(f"structure_from_motion_tpu_torch.ops.{name}")


def counters() -> list:
    """Every kernel wrapper that counts its launches: ``fn.launches``, and
    for B1 and B2 ``fn.by_shape`` (a ``Counter``)."""
    register_ops()
    found = {}
    for name in OPS:
        module = importlib.import_module(f"structure_from_motion_tpu_torch.ops.{name}")
        found.update((id(f), f) for f in vars(module).values()
                     if callable(f) and hasattr(f, "launches"))
    return list(found.values())


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsfm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` for sm_90a unless this exact build exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = {cu: BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in sorted(CSRC.glob("*.cu"))}
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cu, obj in objs.items()
    ]
    logs = [p.communicate()[0] for p in procs]  # waits for every compiler
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    try:
        for cu, p, log in zip(objs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {cu.name} ({p.returncode}):\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs.values())],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stderr}")
    finally:
        for obj in objs.values():
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def ptxas_registers(log: str) -> dict:
    """``{kernel: (registers a thread, spill stores in bytes)}`` from what
    ``ptxas -v`` said (the ``.log`` beside a build); a name demangled by
    ``c++filt`` where it is installed (``ba_reduce_rows<7, false>``), else as
    the compiler mangled it."""
    found = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                       r"Used (\d+) registers", log, re.S)
    names = [f[0] for f in found]
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and names:
        out = subprocess.run([cxxfilt], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
                     for n in out.stdout.splitlines()]
    return {n: (int(regs), int(spill)) for n, (_, spill, regs) in zip(names, found)}


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
