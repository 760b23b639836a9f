"""Share of the profiled solve's wall time in which the card ran nothing:
100 x (1 - the union of the profiler's device operations / window)."""


def read(t):
    d = t.device
    if d is None or not d["window_s"] or not d["union_s"]:
        return None
    return 100.0 * (1.0 - d["union_s"] / d["window_s"])
