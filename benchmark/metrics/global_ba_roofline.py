"""Kernels B4 (``csrc/ba_blocks.cu``: the assembly and its camera
reduction), B5 and B6 (``csrc/ba_matvec.cu``) in the profiled solve against
their bound: each launch the profiler saw priced at the global problem's
shapes (``counts``), over their device time, in percent."""

from benchmark import counts
from benchmark.trace import kernel_time


def read(t):
    d, c = t.device, t.context
    if d is None or not c.get("slots"):
        return None
    n4, s4 = kernel_time(d, "ba_assemble")
    _, s4r = kernel_time(d, "ba_reduce_rows")
    n5, s5 = kernel_time(d, "expand_cam_kernel")
    n6, s6 = kernel_time(d, "reduce_cam_kernel")
    busy = s4 + s4r + s5 + s6
    if not (n4 and n5 and n6 and busy):
        return None
    V = c["n_cams"]
    bound = (n4 * counts.bound_s(*counts.ba_blocks_launch(c["slots"], V))
             + n5 * counts.bound_s(*counts.expand_cam_launch(c["slots"], V))
             + n6 * counts.bound_s(*counts.reduce_cam_launch(c["n_obs"], V, c["cam_rows"])))
    return 100.0 * bound / busy
