"""Operations and bytes of kernel B8 (``csrc/ba_matvec.cu``:
``cam_diag_kernel``, the PCG preconditioner's diagonal blocks), from the
shapes a run gives it, priced as ``counts.py`` prices the other launches:
each input byte read once and each output byte written once, operations
what the function needs. Imports nothing of the port."""

from __future__ import annotations


def cam_diag_launch(filled: int, n_views: int, view_slots: int, width: int = 7) -> tuple:
    """(flops, bytes) of one B8 launch over the camera-major view at a
    camera block of ``width`` (7 or 10): a filled slot reads its W row
    (12 ``width`` B) and its point id (4 B) and forms W D^-1 (18 ``width``
    flops) and the ``width (width + 1) / 2`` entries of its block (6 flops
    each); a view slot reads its id and mask (5 B); each camera writes its
    block (4 ``width``^2 B). Not counted, so the share errs low: each
    point's D^-1 (36 B a point, read once however many slots share it) and,
    with camera tiers, each camera's run (8 B)."""
    flops = (18 * width + 3 * width * (width + 1)) * filled
    nbytes = filled * (12 * width + 4) + 5 * view_slots + 4 * width * width * n_views
    return flops, nbytes
