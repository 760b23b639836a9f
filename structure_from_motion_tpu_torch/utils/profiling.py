"""Timing and tracing helpers (port of
``structure_from_motion_tpu/utils/profiling.py``): wall time bracketed by
``torch.cuda.synchronize()``, ``torch.profiler`` traces, and a non-finite
check over a dict or NamedTuple of tensors."""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any

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
