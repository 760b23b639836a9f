"""ctypes bindings for the native C++ image loader (port of
``structure_from_motion_tpu/io/native_loader.py``).

The same library, built from the same source: ``native/sfm_loader.cpp``
(uncompressed 24/32-bit BMP and binary PGM, BT.601 luma, a pool of decoder
threads that prefetch a sequence). It is built with ``make`` at first use
into ``build/native/libsfm_loader.so`` at the repository root (nothing is
written into ``native/``), and everything here degrades to the Python
decoder of :mod:`structure_from_motion_tpu_torch.io.datasets` when the
library cannot be built or a file is not one it decodes. A host decoder:
the frames it returns are numpy arrays, for the caller to upload.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _ROOT / "native"
_LIB_PATH = _ROOT / "build" / "native" / "libsfm_loader.so"
_lock = threading.Lock()
_lib = None
_build_failed = False
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_INT_P, _FLOAT_P = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {  # name -> (restype, argtypes)
    "sfm_decode": (_I, [ctypes.c_char_p, _INT_P, _INT_P]),
    "sfm_copy_gray": (_I, [_FLOAT_P, _L]),
    "sfm_loader_open": (_P, [ctypes.POINTER(ctypes.c_char_p), _L, _I]),
    "sfm_loader_get": (_I, [_P, _L, _INT_P, _INT_P]),
    "sfm_loader_copy": (_I, [_P, _L, _FLOAT_P, _L]),
    "sfm_loader_close": (None, [_P]),
}


def _load_library():
    """The loaded library, built on first use; None when it cannot be."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not _LIB_PATH.exists():
            _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
            try:
                # a TARGET on the command line overrides the Makefile's own
                subprocess.run(["make", "-C", str(_NATIVE_DIR), f"TARGET={_LIB_PATH}"],
                               check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _build_failed = True
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def decode_grayscale(path: str) -> np.ndarray | None:
    """Decode one image natively -> float32 (H, W), or None if unsupported."""
    lib = _load_library()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.sfm_decode(str(path).encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value), dtype=np.float32)
    rc = lib.sfm_copy_gray(out.ctypes.data_as(_FLOAT_P), out.size)
    return out if rc == 0 else None


class PrefetchingLoader:
    """Background-threaded sequence loader: the decode of frame k+1 overlaps
    the work on frame k. Iterate (or :meth:`get`) for float32 (H, W)
    grayscale arrays; a frame the library cannot decode comes from
    ``io.datasets.load_image_grayscale``."""

    def __init__(self, paths: list, n_threads: int = 2):
        self._paths = [str(p) for p in paths]
        self._lib = _load_library()
        self._handle = None
        if self._lib is not None:
            c_paths = (ctypes.c_char_p * len(self._paths))(*[p.encode() for p in self._paths])
            self._handle = self._lib.sfm_loader_open(c_paths, len(self._paths), n_threads)

    def __len__(self):
        return len(self._paths)

    def get(self, index: int) -> np.ndarray:
        if self._handle:
            w, h = ctypes.c_int(), ctypes.c_int()
            if self._lib.sfm_loader_get(self._handle, index, ctypes.byref(w),
                                        ctypes.byref(h)) == 0:
                out = np.empty((h.value, w.value), dtype=np.float32)
                if self._lib.sfm_loader_copy(self._handle, index, out.ctypes.data_as(_FLOAT_P),
                                             out.size) == 0:
                    return out
        from structure_from_motion_tpu_torch.io.datasets import load_image_grayscale

        return load_image_grayscale(self._paths[index])

    def __iter__(self):
        for i in range(len(self._paths)):
            yield self.get(i)

    def close(self):
        if self._handle and self._lib:
            self._lib.sfm_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
