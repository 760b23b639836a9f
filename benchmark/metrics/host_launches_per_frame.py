"""Kernel and CUDA graph launches the host made a frame (a lane step with
lanes) in the profiled window: the profiler's ``cudaLaunchKernel``-family
and ``cudaGraphLaunch`` runtime calls."""


def read(t):
    if t.device is None or not t.context.get("profiled_steps"):
        return None
    return t.device["launches"] / t.context["profiled_steps"]
