"""Kernel B3 (``csrc/match_top2.cu``) against its bound: one launch a frame,
every stored key of the window's views against the new view's valid keys
(three TF32 products a product, 495 TFLOP/s; the valid keys taken as the
mean over the views the window holds at its end), over the profiler's
device time of the kernel, in percent."""

from benchmark import counts
from benchmark.trace import kernel_time


def read(t):
    d, c = t.device, t.context
    if d is None or not c.get("profiled_steps") or "n_views" not in c:
        return None
    seen, secs = kernel_time(d, "match_top2")
    if seen != c["profiled_steps"] or not secs:
        return None
    flops, nbytes = counts.match_launch(c["n_views"], c["n_keypoints"], c["valid_queries"],
                                        lanes=c["lanes"])
    return 100.0 * seen * counts.bound_s(flops, nbytes, counts.PEAK_TF32_FLOPS) / secs
