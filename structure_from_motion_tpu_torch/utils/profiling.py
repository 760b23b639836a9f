"""Timing and tracing helpers (port of
``structure_from_motion_tpu/utils/profiling.py``): wall time bracketed by
``torch.cuda.synchronize()``, ``torch.profiler`` traces, a non-finite
check over a dict or NamedTuple of tensors, and the program's spans.

A span (:func:`span`) names a stretch of the host's work at a layer
boundary: the restore, the global solve and its phases, an LM iteration, a
host read of a loop's stop mask, a frame and its phases. Spans are off by
default, and then cost one boolean test a site. :func:`enable` turns them
on: each closed span is kept in memory as a :class:`Span` (handed out by
:func:`records`, dropped by :func:`reset`), and while a ``torch.profiler``
records, each is also a ``record_function`` range, so the trace shows the
host's work by these names beside the device's operations. A
span records nothing while the current CUDA stream captures a graph, or
while ``torch.export`` traces (``utils/control.exporting``): a captured
or exported program gains no operation.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from typing import Any, NamedTuple

import torch

logger = logging.getLogger("structure_from_motion_tpu_torch")


def device_fence() -> None:
    """Wait for every kernel queued on the current card (a no-op on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_timer(name: str, results: dict | None = None):
    """Wall-time the body with the card drained before and after."""
    device_fence()
    t0 = time.perf_counter()
    holder: list[Any] = []
    yield holder
    device_fence()
    dt = time.perf_counter() - t0
    logger.info("%s: %.4fs", name, dt)
    if results is not None:
        results[name] = dt


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the body (CPU and, with a card, CUDA
    activity), written to ``log_dir`` for TensorBoard's profile plugin."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def _leaves(tree, path: str = ""):
    if torch.is_tensor(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def nan_guard(tree, label: str = "") -> bool:
    """True (and a logged error a leaf) if any floating tensor of ``tree``
    (a tensor, dict, NamedTuple, list or tuple of them) holds a non-finite
    value."""
    bad = False
    for path, leaf in _leaves(tree):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            logger.error("non-finite values in %s%s", label, path)
            bad = True
    return bad


# -- spans ---------------------------------------------------------------------


class Span(NamedTuple):
    """One closed span. ``id`` counts from 1 in opening order; ``start_ns``
    and ``end_ns`` are ``time.perf_counter_ns()``; ``parent`` is the id of
    the span open around it on its thread (None for a root); ``root`` the
    id of its outermost span (the request: one solve, one restore, one
    frame); ``self_ns`` its duration less its children's."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    root: int
    self_ns: int


_ON = False  # the one test a span makes while tracing is off
_NULL = contextlib.nullcontext()
_RECORDS: list = []  # closed spans, in closing order
_IDS = itertools.count(1)
_THREAD = threading.local()  # .open: the spans open on this thread, innermost last


def enable(on: bool = True) -> None:
    """Turn the spans on or off (off at import)."""
    global _ON
    _ON = bool(on)


def reset() -> None:
    """Drop the spans recorded so far (spans still open are kept when they close)."""
    _RECORDS.clear()


def records() -> list:
    """The :class:`Span` of each span closed since :func:`reset`, in closing
    order (a parent after its children)."""
    return list(_RECORDS)


def _quiet() -> bool:
    """True where a span must record nothing: while ``torch.export`` traces
    (``utils/control.exporting``'s test: control imports this module), or
    inside a CUDA graph capture on the current stream."""
    return torch.compiler.is_exporting() or (torch.cuda.is_initialized()
                                             and torch.cuda.is_current_stream_capturing())


class _Open:
    """A span being recorded (see :func:`span`)."""

    __slots__ = ("name", "id", "parent", "root", "start", "children", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _quiet():
            self.id = None
            return self
        stack = _THREAD.__dict__.setdefault("open", [])
        outer = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = outer.id if outer is not None else None
        self.root = outer.root if outer is not None else self.id
        self.children = 0
        stack.append(self)
        self.start = time.perf_counter_ns()
        # a range costs some microseconds: opened only where a profiler records
        self.range = (torch.profiler.record_function(self.name)
                      if torch.autograd._profiler_enabled() else None)
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.id is None:
            return False
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.perf_counter_ns()
        stack = _THREAD.open
        stack.pop()
        took = end - self.start
        if stack:
            stack[-1].children += took
        _RECORDS.append(Span(self.id, self.name, self.start, end, self.parent, self.root,
                             took - self.children))
        return False


def span(name: str):
    """A context manager that records the block as a span named ``name``
    while tracing is on (:func:`enable`), nested in the span open around it
    on this thread, and opens a ``torch.profiler.record_function`` range
    of that name where a profiler records; while tracing is off, one shared
    context that does nothing."""
    if not _ON:
        return _NULL
    return _Open(name)
