"""Kernel B8 (``csrc/ba_matvec.cu``: ``cam_diag_kernel``, the block-Jacobi
preconditioner's diagonal blocks, once an LM iteration, with the
``cam_diag_fold`` launch that adds its parts where it has several) in the
profiled solve against its bound: each launch the profiler saw priced at the
problem's shapes (``counts_diag``: the filled slots ``obs`` or ``n_obs``,
the view's slots ``cam_slots`` or ``n_cams`` x ``cam_rows``, the camera
block ``cam_width``, 7 where absent), over their device time, in percent.
Each point's D^-1 (M x 36 B) is not in the trace's context and is left
out of the bytes, so the share errs low (~5% at BAL Venice), never high.
Nothing to read where the program has no such kernel."""

from benchmark import counts, counts_diag
from benchmark.trace import kernel_time


def read(t):
    d, c = t.device, t.context
    if d is None:
        return None
    n, s = kernel_time(d, "cam_diag_kernel")
    s += kernel_time(d, "cam_diag_fold")[1]
    filled = c.get("obs") or c.get("n_obs")
    V = c.get("n_cams")
    view = c.get("cam_slots") or (V and c.get("cam_rows") and V * c["cam_rows"])
    if not (n and s and filled and V and view):
        return None
    width = c.get("cam_width") or 7
    bound = n * counts.bound_s(*counts_diag.cam_diag_launch(filled, V, view, width))
    return 100.0 * bound / s
