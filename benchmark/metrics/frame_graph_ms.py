"""Device milliseconds of a steady frame's ``graphed`` call (its input
copies, the CUDA graph replay and its output copies): CUDA events recorded
on the current stream just before and after the call, the mean over the
traced run's measured window."""


def read(t):
    if not t.graph_ms:
        return None
    return sum(t.graph_ms) / len(t.graph_ms)
