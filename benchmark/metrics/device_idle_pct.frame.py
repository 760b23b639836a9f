"""Share of the profiled frames' wall time in which the card ran nothing:
100 x (1 - busy / window), busy being the union of the device operations
outside CUDA graph replays and of each replay's extent, from its first to
its last operation the profiler saw (``trace.read_profile``)."""


def read(t):
    d = t.device
    if d is None or not d["window_s"] or not d["busy_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
