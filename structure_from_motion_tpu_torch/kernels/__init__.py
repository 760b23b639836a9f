"""Build and load the hand-written Hopper kernels under ``csrc/``.

All ``csrc/*.cu`` sources compile with ``nvcc`` into ONE shared library with
a plain C interface, ``build/torch_kernels/libsfm_kernels_<hash>.so`` at the
repository root, named by a hash of the sources and flags so an edited
kernel never loads a stale build. It is loaded with ``ctypes``: pointers and
the CUDA stream pass as ``c_void_p``, every entry point returns
``cudaGetLastError()`` and :func:`check` raises when that is not 0.

The build runs at the first launch of any kernel (never at import: the CPU
tests import every module on a machine without ``nvcc``). There is no
fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argtypes (all return int = cudaError_t)
_SIGNATURES = {
    # base, taps (L, 33), radii (L,), L, H, W, mid, out, stream
    "sfm_blur_levels": (_P, _P, _P, _I, _I, _I, _P, _P, _P),
    # dog, S, H, W, contrast, edge_r, (edge_r + 1)^2, border, out, stream
    "sfm_candidate_response": (_P, _I, _I, _I, _F, _F, _F, _I, _P, _P),
    # ref, que, sqq, mask_que, Nr, Nq, d1, d2, j1, stream
    "sfm_match_top2": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P),
    # cam, C, q, X, uv, w, O, V, huber, dtd, wblk, bp, partial, cam_out, stream
    "sfm_ba_blocks": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P, _P),
    # cam, w21, x, O, V, t, stream
    "sfm_expand_cam": (_P, _P, _P, _I, _I, _P, _P),
    # w21, y, perm, mask, O, V, rows, coup, stream
    "sfm_reduce_cam": (_P, _P, _P, _P, _I, _I, _I, _P, _P),
}


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
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cus = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *cus], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
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


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
