"""Kernels B1 (``csrc/blur.cu``) and B2 (``csrc/cand.cu``: the fused block
kernel and the response map) against their bound: the sum of the bound
times of every launch of the profiled frames (``counts.detect_launches``
from the configuration's shapes) over the sum of the profiler's device
times of those kernels, in percent. Nothing is read unless the profiler saw
each kernel as many times as the frames launch it."""

import collections

from benchmark import counts
from benchmark.trace import kernel_time


def read(t):
    d, c = t.device, t.context
    if d is None or not c.get("profiled_steps") or "frontend" not in c:
        return None
    model = counts.detect_launches(c["frontend"], c["frame_size"], c["lanes"])
    launches = collections.Counter(k for k, _, _ in model)
    bound, busy = 0.0, 0.0
    for name, n in launches.items():
        seen, secs = kernel_time(d, name)
        if seen != n * c["profiled_steps"]:
            return None
        busy += secs
    for _, flops, nbytes in model:
        bound += counts.bound_s(flops, nbytes) * c["profiled_steps"]
    return 100.0 * bound / busy if busy else None
