"""Kernels B4 (``csrc/ba_blocks.cu``: ``ba_assemble<10>`` and its camera
reduction ``ba_reduce_rows<10, ...>``), B5 and B6 (``csrc/ba_matvec.cu``:
``expand_cam_kernel<10>``, ``reduce_cam_kernel<10, ...>``) at the self-calibrating
camera block in the profiled solve against their bound: each launch the
profiler saw priced at the problem's shapes (``counts_selfcal``), over their
device time, in percent."""

from benchmark import counts, counts_selfcal
from benchmark.trace import kernel_time


def read(t):
    d, c = t.device, t.context
    if d is None or not (c.get("slots") and c.get("cam_slots") and c.get("obs")):
        return None
    n4, s4 = kernel_time(d, "ba_assemble<10>")
    _, s4r = kernel_time(d, "ba_reduce_rows<10,")
    n5, s5 = kernel_time(d, "expand_cam_kernel<10>")
    n6, s6 = kernel_time(d, "reduce_cam_kernel<10,")
    busy = s4 + s4r + s5 + s6
    if not (n4 and n5 and n6 and busy):
        return None
    V = c["n_cams"]
    bound = (n4 * counts.bound_s(*counts_selfcal.ba_blocks10_launch(c["slots"], V))
             + n5 * counts.bound_s(*counts_selfcal.expand_cam10_launch(c["slots"], V))
             + n6 * counts.bound_s(*counts_selfcal.reduce_cam10_launch(c["obs"], V,
                                                                      c["cam_slots"])))
    return 100.0 * bound / busy
