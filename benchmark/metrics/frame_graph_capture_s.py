"""Seconds the set-up spent capturing and instantiating the frame's CUDA
graphs (the pass in ``device_form`` included): the program's own counters
``utils/control.stats.capture_s`` and ``instantiate_s`` at the end of set-up."""


def read(t):
    return t.context.get("capture_s")
