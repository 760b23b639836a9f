"""Control flow that runs eagerly in the live engine and stays in the graph
when a frame program is exported (``serve.py``).

The JAX package picks a frame's stage and its bucket sizes with
``lax.switch`` and runs its LM refinements as ``while_loop``s, all inside
one compiled program. Here:

* :func:`switch` picks one of several branches by an index. Eagerly it
  reads a tensor index once on the host and runs only that branch (a
  Python int costs no read). While ``torch.export`` traces, it becomes a
  balanced tree of ``cond`` nodes, each making one host read when the
  exported program runs.
* :func:`loop` is a ``while`` loop over a tuple of tensors: eagerly a
  Python ``while`` with one host read a test; while exporting a
  ``while_loop`` node.
* :func:`fori` is a loop of a fixed trip count (the JAX package's
  ``fori_loop`` and ``scan``): eagerly a Python ``for`` (no host read);
  while exporting a ``while_loop`` node whose body is traced once, not
  once an iteration. An exported program's size, and its export, save and
  load times, follow the number of traced operators.

:func:`take` and :func:`put` index one position of an axis by a Python int
or by a 0-dim tensor (no host read), for code that both paths run;
:func:`lane_map` is ``vmap`` over a lane axis, but runs a stack of one lane
on the lane itself (an exported program holds no ``vmap``).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree


def take(t: torch.Tensor, i, dim: int = 0) -> torch.Tensor:
    """``t`` at index ``i`` of ``dim``: ``i`` a Python int (a view) or a
    0-dim integer tensor (a gather)."""
    if torch.is_tensor(i):
        return t.index_select(dim, i.reshape(1).long()).squeeze(dim)
    return t.select(dim, i)


def put(t: torch.Tensor, i, val, dim: int = 0) -> torch.Tensor:
    """A copy of ``t`` with index ``i`` of ``dim`` set to ``val`` (a tensor
    or a Python scalar; ``i`` as in :func:`take`)."""
    if torch.is_tensor(i):
        val = (val.to(t.dtype) if torch.is_tensor(val)
               else torch.full((), val, dtype=t.dtype, device=t.device))
        val = val.expand(t.shape[:dim] + t.shape[dim + 1:]).unsqueeze(dim)
        return t.index_copy(dim, i.reshape(1).long(), val)
    out = t.clone()
    out.select(dim, i).copy_(val.to(t.dtype) if torch.is_tensor(val) else val)
    return out


@contextlib.contextmanager
def export_tracing():
    """Enter around ``torch.export.export`` of a program with these control
    flow nodes: no Python stack trace on each traced node (a large share of
    the export time; the artifact has no use for them)."""
    # (the switch is newer than some torch releases: then traces stay)
    stack_traces = getattr(torch.fx.config, "do_not_emit_stack_traces", None)
    if stack_traces is not None:
        torch.fx.config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        if stack_traces is not None:
            torch.fx.config.do_not_emit_stack_traces = stack_traces


def lane_map(fn, *args):
    """``torch.func.vmap(fn)(*args)`` over the leading (lane) axis of every
    argument, except for a stack of one lane: ``fn`` on lane 0, the axis put
    back. An exported program cannot hold a ``vmap`` (torch's serializer
    refuses its nesting calls, and a ``cond`` branch drops them), and only
    one-lane engines are exported, so their per-lane geometry runs on the
    lane itself, live and served alike."""
    if args[0].shape[0] != 1:
        return torch.func.vmap(fn)(*args)
    out = fn(*(a[0] for a in args))
    return pytree.tree_map(lambda t: t[None], out)


def exporting() -> bool:
    """True while ``torch.export`` traces (non-strict)."""
    return torch.compiler.is_exporting()


def _no_tensor_closure(fn) -> None:
    cells = getattr(fn, "__closure__", None) or ()
    held = [c.cell_contents for c in cells if c.cell_contents is not None]
    held += list(getattr(fn, "args", ())) + list(getattr(fn, "keywords", {}).values())
    if any(torch.is_tensor(x) for h in held for x in pytree.tree_leaves(h)
           if not callable(h)):
        raise ValueError(f"{getattr(fn, '__name__', fn)} closes over a tensor: pass it as an "
                         "operand, or the exported program bakes it in")


def _fresh(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in row-major order: a cond branch or loop body must
    return dense tensors that share no storage with its inputs (a store's
    slice of its dump-row buffer is not dense, an unchanged state field is
    the input itself). The data stay as they are."""
    return x.clone(memory_format=torch.contiguous_format)


def _split(tree):
    """(tensor leaves, rebuild(tensors) -> tree): non-tensor leaves stay
    Python constants of the trace."""
    leaves, spec = pytree.tree_flatten(tree)
    pos = [i for i, x in enumerate(leaves) if torch.is_tensor(x)]
    consts = [None if torch.is_tensor(x) else x for x in leaves]

    def rebuild(tensors):
        full = list(consts)
        for i, t in zip(pos, tensors):
            full[i] = t
        return pytree.tree_unflatten(full, spec)

    return [leaves[i] for i in pos], rebuild


def switch(index, branches, *operands):
    """``branches[index](*operands)``. Every branch returns the same
    structure of tensors (same shapes and dtypes); ``index`` is a Python
    int or a 0-dim integer tensor in ``[0, len(branches))``."""
    if not torch.is_tensor(index):
        return branches[index](*operands)
    if not exporting():
        return branches[int(index)](*operands)
    if len(branches) == 1:
        return branches[0](*operands)
    cond_op = torch.ops.higher_order.cond
    for fn in branches:
        _no_tensor_closure(fn)
    tensors, rebuild = _split(operands)
    out_specs = []

    def flat(fn):
        def run(_index, *ts):
            leaves, spec = pytree.tree_flatten(fn(*rebuild(ts)))
            if not all(torch.is_tensor(x) for x in leaves):
                raise TypeError("a switch branch must return tensors only")
            out_specs.append(spec)
            return tuple(_fresh(x) for x in leaves)
        return run

    def tree(lo, hi):  # branches [lo, hi) as a balanced tree of conds
        if hi - lo == 1:
            return flat(branches[lo])
        mid = (lo + hi + 1) // 2  # the last branch (the busiest stage) shallowest
        low, high = tree(lo, mid), tree(mid, hi)
        return lambda idx, *ts: cond_op(idx < mid, low, high, (idx, *ts))

    out = tree(0, len(branches))(index.reshape(()).long(), *tensors)
    if any(spec != out_specs[0] for spec in out_specs):
        raise TypeError("switch branches return different structures")
    return pytree.tree_unflatten(list(out), out_specs[0])


def loop(cond_fn, body_fn, carried: tuple, *operands) -> tuple:
    """``while cond_fn(*carried, *operands): carried = body_fn(*carried,
    *operands)``, then ``carried``. ``carried`` is a tuple of tensors whose
    shapes and dtypes the body keeps; ``cond_fn`` returns a one-element
    bool tensor; ``operands`` (any structure of tensors and constants) are
    read, never changed."""
    carried = tuple(carried)
    if not exporting():
        while bool(cond_fn(*carried, *operands)):
            carried = tuple(body_fn(*carried, *operands))
        return carried
    while_loop_op = torch.ops.higher_order.while_loop
    _no_tensor_closure(cond_fn)
    _no_tensor_closure(body_fn)
    tensors, rebuild = _split(operands)
    n = len(carried)

    def cond(*xs):
        return cond_fn(*xs[:n], *rebuild(xs[n:])).reshape(())

    def body(*xs):
        return tuple(_fresh(x) for x in body_fn(*xs[:n], *rebuild(xs[n:])))

    return tuple(while_loop_op(cond, body, carried, tuple(tensors)))


def fori(n: int, body_fn, carried: tuple, *operands) -> tuple:
    """``for i in range(n): carried = body_fn(i, *carried, *operands)``,
    then ``carried``: ``i`` a Python int eagerly, a 0-dim int64 tensor in
    an exported program (the body is traced once). ``carried`` and
    ``operands`` as in :func:`loop`."""
    carried = tuple(carried)
    if not exporting():
        for i in range(n):
            carried = tuple(body_fn(i, *carried, *operands))
        return carried
    if n == 0:
        return carried
    _no_tensor_closure(body_fn)
    i0 = torch.zeros((), dtype=torch.long, device=carried[0].device)
    out = loop(lambda i, *_: i < n, lambda i, *rest: (i + 1, *body_fn(i, *rest)),
               (i0, *carried), *operands)
    return out[1:]
