"""What a run records besides its end-to-end numbers, and the readings the
per-layer metrics take from it.

Spans and counts are recorded from the benchmark's own files, around its
calls into the port's layers (``process_image`` / ``process_images``, the
``graphed`` name that ``models/incremental.py`` calls for a steady frame,
``global_ba.build_global_problem``, ``finalize_global``); the program's own
counters (``utils/control.stats``, ``device.HostCopy.waits``) are read, not
changed. The device's side comes from ``torch.profiler`` over a short
traced window after the measured one: kernel names and device times, the
host's kernel and graph launches, and the kernels of each CUDA graph
replay, told apart by the correlation id of the ``cudaGraphLaunch`` that
ran them.
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings

import torch

# what torch says of a synchronising call (and not of its debug mode itself)
SYNC_MESSAGE = "called a synchronizing"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
            "cudaGraphLaunch", "cuGraphLaunch")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


class Trace:
    """One run's record. ``on`` is the run's ``--trace``: off, only the
    set-up's counters are kept and nothing is wrapped."""

    def __init__(self, on: bool):
        self.on = on
        self.spans: dict = collections.defaultdict(list)  # name -> host seconds
        self.counts: collections.Counter = collections.Counter()
        self.context: dict = {}  # shapes and sizes the readers need
        self.graph_ms: list = []  # device ms of each steady frame's graphed call
        self.device: dict | None = None  # the profiled window, see :func:`read_profile`
        self._events: list = []
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str):
        """Host time of the block under ``name``; inside the profiled window
        also a profiler range, which names the host's work in idle gaps."""
        rf = torch.profiler.record_function(name) if self.on else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    def wrap(self, module, name: str):
        """Replace ``module.name`` by a call timed under its name; returns a
        function that puts the original back."""
        fn = getattr(module, name)

        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        setattr(module, name, timed)
        return lambda: setattr(module, name, fn)

    def wrap_graphed(self, module):
        """Record CUDA events on the current stream around each outermost
        ``graphed`` call of ``module`` made outside a capture (a steady
        frame's replay with its input and output copies); returns the undo."""
        fn = module.graphed

        def timed(f, *operands, calls=None):
            if self._depth or torch.cuda.is_current_stream_capturing() \
                    or not torch.cuda.is_available():
                return fn(f, *operands, calls=calls)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self._depth += 1
            try:
                a.record()
                out = fn(f, *operands, calls=calls)
                b.record()
            finally:
                self._depth -= 1
            self._events.append((a, b))
            return out

        module.graphed = timed
        return lambda: setattr(module, "graphed", fn)

    def take_graph_times(self) -> None:
        """Device ms of the graphed calls since the last take (synchronises)."""
        torch.cuda.synchronize()
        self.graph_ms.extend(a.elapsed_time(b) for a, b in self._events)
        self._events.clear()

    @contextlib.contextmanager
    def host_syncs(self, key: str = "host_syncs"):
        """Count under ``key`` every host synchronisation torch's debug mode
        reports in the block (``set_sync_debug_mode("warn")``)."""
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            shown = warnings.showwarning

            def show(message, *args, **kwargs):
                if SYNC_MESSAGE in str(message):
                    self.counts[key] += 1
                else:
                    shown(message, *args, **kwargs)

            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(mode)


def profile():
    """The profiler over the traced window: the host's calls and the
    device's operations."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _union(spans: list) -> tuple:
    """(merged intervals, their total length) of (start, end) pairs."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged, sum(b - a for a, b in merged)


def read_profile(prof, window_s: float) -> dict:
    """The device's side of a profiled window (times in seconds):

    * ``kernels``: name -> [launches, device s], every device operation;
    * ``launches``: the host's kernel and graph launches;
    * ``graph_launches``;
    * ``busy_s``: the union of the device's operations outside graph
      replays and of each replay's extent, from its first to its last
      operation the profiler saw (CUPTI reports no kernel that runs inside
      a conditional node, so a replay's own operations undercount it);
    * ``union_s``: the union of every operation the profiler saw;
    * ``gaps``: host span name -> idle device seconds, each gap between
      busy intervals named by the innermost benchmark span around its
      middle ("host" where none is);
    * ``window_s``."""
    events = prof.events()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    graph_ids = {e.id for e in events if e.device_type == cpu and e.name in GRAPH_LAUNCHES}
    launches = sum(1 for e in events if e.device_type == cpu and e.name in LAUNCHES)
    names = {e.name for e in events if e.device_type == cpu
             and getattr(e, "is_user_annotation", False)}
    kernels: dict = collections.defaultdict(lambda: [0, 0.0])
    outside, extents, every = [], {}, []
    for e in events:
        # a benchmark span shows on the device's timeline too: not an operation
        if e.device_type != cuda or getattr(e, "is_user_annotation", False) or e.name in names:
            continue
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        k = kernels[e.name]
        k[0] += 1
        k[1] += b - a
        every.append((a, b))
        if e.id in graph_ids:
            lo, hi = extents.get(e.id, (a, b))
            extents[e.id] = (min(lo, a), max(hi, b))
        else:
            outside.append((a, b))
    merged, busy = _union(outside + list(extents.values()))
    _, union_s = _union(every)
    spans = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name) for e in events
             if e.device_type == cpu and getattr(e, "is_user_annotation", False)]
    gaps: collections.Counter = collections.Counter()
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + start)
        around = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(around, key=lambda s: s[1] - s[0])[2] if around else "host"
        gaps[name] += start - end
    return dict(kernels={k: list(v) for k, v in kernels.items()}, launches=launches,
                graph_launches=len(graph_ids), busy_s=busy, union_s=union_s,
                gaps=dict(gaps), window_s=window_s)


def kernel_time(device: dict, *names: str) -> tuple:
    """(launches, device s) of the kernels whose name holds one of
    ``names`` as a word of the C++ signature."""
    n, s = 0, 0.0
    for k, (count, secs) in device["kernels"].items():
        if any(_holds(k, name) for name in names):
            n += count
            s += secs
    return n, s


def _holds(signature: str, name: str) -> bool:
    i = signature.find(name)
    while i >= 0:
        before = signature[i - 1] if i else " "
        after = signature[i + len(name):i + len(name) + 1] or " "
        if not (before.isalnum() or before == "_") and not (after.isalnum() or after == "_"):
            return True
        i = signature.find(name, i + 1)
    return False


def breakdown(device: dict) -> dict:
    """The contract's ``breakdown``: the ten device operations that took the
    most time, and the ten largest idle shares by what the host was doing."""
    ops = sorted(((k, v[1]) for k, v in device["kernels"].items()), key=lambda kv: -kv[1])
    gaps = sorted(device["gaps"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:120], s] for k, s in ops[:10]],
            "idle_gaps": [[k[:120], s] for k, s in gaps[:10]]}
