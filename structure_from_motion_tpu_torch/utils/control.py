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
* :func:`masked_loop` is the JAX package's convergence ``while_loop`` (the
  LM and PCG loops): a step that updates only the problems its device-side
  mask leaves active, the mask read on the host once every ``k`` steps. On
  the card each chunk of ``k`` steps is one CUDA graph replay; on the CPU
  the chunk runs eagerly; while exporting it is a ``while_loop`` of masked
  steps. :func:`masked_loop_reference`, one step and one host read at a
  time, is its plain version.

An exported ``while_loop`` node of :func:`fori` or :func:`masked_loop`
carries its kind, ``n`` and ``k`` in ``meta["custom"]`` (a plain
:func:`loop` carries none); ``serve.py`` points each node at
:func:`served_fori` or :func:`served_masked_loop`, so a served program
runs its loops as the live engine does: a fixed loop with no host read, a
masked one in the same chunks, reads and CUDA graphs as live.

:func:`take` and :func:`put` index one position of an axis by a Python int
or by a 0-dim tensor (no host read), for code that both paths run;
:func:`lane_map` is ``vmap`` over a lane axis, but runs a stack of one lane
on the lane itself (an exported program holds no ``vmap``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import time

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
    read, never changed. Exported, its ``while_loop`` node carries no loop
    tag (:func:`fori` and :func:`masked_loop` tag theirs), so a served
    engine refuses it."""
    return _loop(None, cond_fn, body_fn, carried, operands)


def loop_tag(custom) -> dict | None:
    """The loop tag in a node's ``meta["custom"]`` (its kind, ``n`` and,
    for a masked loop, ``k``), or None."""
    if not custom or not custom.get("sfm_loop"):
        return None
    keys = ("sfm_loop", "n", "k") if custom["sfm_loop"] == "masked" else ("sfm_loop", "n")
    return {key: custom[key] for key in keys}


def _loop(tag, cond_fn, body_fn, carried, operands) -> tuple:
    """:func:`loop`; while exporting, the ``while_loop`` node's
    ``meta["custom"]`` holds ``tag`` (``{"sfm_loop": kind, "n": .., "k":
    ..}``: how ``serve.py`` runs it). Node metadata is kept
    (``preserve_node_meta``) for the loop's own nodes alone: on every node
    of a program it slowed the save by half on the card."""
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
    meta = torch.fx.traceback

    def cond(*xs):
        with meta.preserve_node_meta(False):
            return cond_fn(*xs[:n], *rebuild(xs[n:])).reshape(())

    def body(*xs):
        with meta.preserve_node_meta(False):
            return tuple(_fresh(x) for x in body_fn(*xs[:n], *rebuild(xs[n:])))

    with meta.preserve_node_meta(), meta.annotate(tag or {"sfm_loop": None}):
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
    out = _loop({"sfm_loop": "fori", "n": n}, lambda i, *_: i < n,
                lambda i, *rest: (i + 1, *body_fn(i, *rest)), (i0, *carried), operands)
    return out[1:]


# -- convergence loops: a device-side stop mask read once every k steps -------


@dataclasses.dataclass
class LoopStats:
    """What :func:`masked_loop` did since :func:`reset_stats`: host reads of
    the stop mask, CUDA graph captures (and their seconds), replays, the
    reserved memory the captures added to the shared graph pool, and the
    bytes of the graphs' static input buffers."""

    reads: int = 0
    captures: int = 0
    capture_s: float = 0.0
    replays: int = 0
    pool_bytes: int = 0
    static_bytes: int = 0


stats = LoopStats()
_GRAPHS: dict = {}  # key of a call site and its shapes -> _Graph
_POOLS: dict = {}  # device -> the graph memory pool every capture shares


def reset_stats() -> None:
    """Set every field of :data:`stats` to 0 (the graphs stay)."""
    for f in dataclasses.fields(stats):
        setattr(stats, f.name, f.default)


def _read(flag: torch.Tensor) -> bool:
    stats.reads += 1
    return bool(flag)


def _masked_step(n: int, step_fn, i, carried: tuple, operands: tuple):
    """Step ``i`` of a masked loop: the problems still active and below the
    cap take it, every other keeps its iterate (``step_fn``'s contract)."""
    active = carried[0] & (i < n)
    return i + 1, tuple(step_fn(active, *carried[1:], *operands))


def _loop_step(n: int, step_fn, m: int, i, *xs):
    """:func:`_masked_step` as a :func:`loop` body (``xs``: ``m`` carried,
    then the operands)."""
    i, carried = _masked_step(n, step_fn, i, xs[:m], xs[m:])
    return (i, *carried)


def _live_step(n: int, step_fn, rebuild, i, carried: tuple, tensors):
    """:func:`_masked_step` over the operands' tensor leaves."""
    return _masked_step(n, step_fn, i, carried, rebuild(tensors))


def _body_step(body, i, carried: tuple, tensors):
    """One call of an exported masked loop's body ``(i, *carried,
    *operands) -> (i + 1, *carried')``: a masked step."""
    out = body(i, *carried, *tensors)
    return out[0], tuple(out[1:])


def masked_loop(n: int, k: int, step_fn, carried: tuple, *operands, capture: bool = True) -> tuple:
    """The convergence loop of the JAX package's LM and PCG ``while_loop``s,
    stopped on the device: ``carried`` is ``(active, *state)`` with
    ``active`` a bool tensor, one entry a problem (or 0-dim);
    ``step_fn(active, *state, *operands)`` returns ``(active', *state')``,
    changing only the problems where ``active`` is true (``torch.where``:
    the others keep their iterate bit for bit) and with ``active'`` false
    wherever ``active`` is. A step is given ``active & (i < n)``, so no step
    past ``n`` applies, and the result is the iterate and stop point of the
    per-step loop (:func:`masked_loop_reference`; only ``active`` differs:
    false for the problems the cap stopped, where the per-step loop stops
    with them still set). ``operands`` (any structure of tensors and
    constants) are read, never changed.

    The steps run in ``ceil(n / k)`` chunks of ``ceil(n / ceil(n / k))``
    steps (at most ``k``; a loop that runs to its cap runs fewer steps past
    it), with one host read of ``any(active)`` after each chunk that leaves
    steps below ``n``:

    * on CUDA tensors each chunk is one replay of a CUDA graph, captured at
      the first call of this ``step_fn`` (its code and constants), ``n``,
      the chunk and these shapes and dtypes, after one warm-up chunk on a side
      stream; every graph shares one memory pool, and the inputs are
      copied into its buffers at each call. A replay adds the launches of
      the kernels its graph holds to their wrappers' counts. ``step_fn``
      reads no tensor but its arguments, and makes no host read (the
      capture runs under ``torch.cuda.set_sync_debug_mode("error")``); a
      capture or replay that fails raises;
    * with ``capture=False`` (an all-reduce through gloo in the step cannot
      be captured: the sharded PCG), and on the CPU, the chunks run
      eagerly;
    * while ``torch.export`` traces: one :func:`loop` of masked steps
      tagged ``{"sfm_loop": "masked", "n": n, "k": k}``. Run as it is, its
      predicate is read once a step; ``serve.py`` runs the node with
      :func:`served_masked_loop` instead, the same chunks as here.
    """
    carried = tuple(carried)
    if n <= 0:
        return carried
    if exporting():
        i0 = torch.zeros((), dtype=torch.long, device=carried[0].device)
        return _loop({"sfm_loop": "masked", "n": n, "k": k},
                     lambda i, active, *_: (i < n) & active.any(),
                     functools.partial(_loop_step, n, step_fn, len(carried)), (i0, *carried),
                     operands)[1:]
    tensors, rebuild = _split(operands)

    def graph_key():
        leaves, spec = pytree.tree_flatten(operands)
        return (_const_key(step_fn), spec,
                tuple(_const_key(x) for x in leaves if not torch.is_tensor(x)))

    return _chunks(n, k, functools.partial(_live_step, n, step_fn, rebuild), 0, carried,
                   tensors, graph_key if capture else None)[1]


def served_masked_loop(cond, body, carried, operands, n: int, k: int) -> tuple:
    """An exported :func:`masked_loop` node run as the live loop runs:
    ``cond`` and ``body`` are the ``while_loop`` node's graphs, ``carried``
    ``(i, active, *state)``; ``body`` is one masked step. The same chunks,
    host reads, graphs (one a body and its shapes) and stats as
    :func:`masked_loop`; ``cond`` is not run. Returns the node's outputs."""
    i, out = _chunks(n, k, functools.partial(_body_step, body), carried[0], tuple(carried[1:]),
                     tuple(operands), lambda: body)
    return (i.clone(), *out)


def served_fori(cond, body, carried, operands, n: int) -> tuple:
    """An exported :func:`fori` node run as the live loop runs: ``body``
    called ``n`` times, no host read (``cond`` is not run)."""
    carried = tuple(carried)
    for _ in range(n):
        carried = tuple(body(*carried, *operands))
    return carried


def _chunks(n: int, k: int, step, i, carried: tuple, tensors, graph_key=None):
    """``(i, carried)`` after the masked steps ``step(i, carried, tensors)
    -> (i + 1, carried')`` run in :func:`masked_loop`'s chunks: on CUDA
    tensors, one graph replay a chunk when ``graph_key`` (a function
    returning the step's key) is given, else eagerly."""
    k = -(-n // -(-n // k))
    if graph_key is not None and carried[0].is_cuda:
        return _replay_chunks(graph_key(), n, k, step, carried, list(tensors))
    done = 0
    while True:
        for _ in range(k):
            i, carried = step(i, carried, tensors)
        done += k
        if done >= n or not _read(carried[0].any()):
            return i, carried


def masked_loop_reference(n: int, k: int, step_fn, carried: tuple, *operands,
                          capture: bool = True) -> tuple:
    """Plain version of :func:`masked_loop` (same arguments; ``k`` and
    ``capture`` are not read): one step at a time while a problem is active
    and fewer than ``n`` steps ran, one host read a step."""
    carried = tuple(carried)
    i = 0
    while i < n and bool(carried[0].any()):
        carried = tuple(step_fn(carried[0], *carried[1:], *operands))
        i += 1
    return carried


def _const_key(x):
    """A hashable key of a constant a captured step reads (a function's
    code and what it closes over, a partial's arguments); a tensor there is
    refused: the graph would hold its address."""
    if torch.is_tensor(x):
        raise ValueError("a captured step closes over a tensor: pass it as an operand")
    if isinstance(x, functools.partial):
        return (_const_key(x.func), _const_key(x.args),
                tuple(sorted((name, _const_key(v)) for name, v in x.keywords.items())))
    code = getattr(x, "__code__", None)
    if code is not None:
        cells = tuple(_const_key(c.cell_contents) for c in x.__closure__ or ())
        return (code, cells, _const_key(x.__defaults__ or ()))
    if isinstance(x, (tuple, list)):
        return tuple(_const_key(v) for v in x)
    hash(x)
    return x


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    i: torch.Tensor  # the step counter
    carried: list  # the carried buffers: a replay leaves its result there
    operands: list  # the operand buffers
    flag: torch.Tensor  # any problem active after the chunk (an output of the graph)
    launches: list  # (wrapper, launches, by shape) of the kernels a replay runs


@contextlib.contextmanager
def _sync_errors():
    """A host synchronisation raises inside the block."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _launch_counts(wrappers) -> list:
    return [(f, f.launches, collections.Counter(getattr(f, "by_shape", {}))) for f in wrappers]


def _capture(n: int, k: int, step, carried: tuple, tensors: list) -> _Graph:
    """Warm one chunk of ``step`` up on a side stream, then capture it into
    a graph of the shared pool; the launches the capture counted become the
    graph's."""
    from structure_from_motion_tpu_torch import kernels

    dev = carried[0].device
    i = torch.zeros((), dtype=torch.long, device=dev)
    static_c = [t.clone() for t in carried]
    static_o = [t.clone() for t in tensors]

    def chunk():
        j, c = i, tuple(static_c)
        for _ in range(k):
            j, c = step(j, c, static_o)
        i.copy_(j)
        for s, t in zip(static_c, c):
            s.copy_(t)
        return c[0].any()

    t0 = time.perf_counter()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side), _sync_errors():
        chunk()  # creates the library handles and workspaces a capture cannot
    torch.cuda.current_stream(dev).wait_stream(side)
    wrappers = kernels.counters()
    before = _launch_counts(wrappers)
    if dev not in _POOLS:
        _POOLS[dev] = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=_POOLS[dev], capture_error_mode="thread_local"):
        reserved = torch.cuda.memory_reserved(dev)
        with _sync_errors():
            flag = chunk()
        stats.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
    launches = []
    for (f, n0, s0), (_, n1, s1) in zip(before, _launch_counts(wrappers)):
        launches.append((f, n1 - n0, s1 - s0))
        f.launches = n0  # nothing ran: the counts go back, the graph keeps them
        if hasattr(f, "by_shape"):
            f.by_shape.clear()
            f.by_shape.update(s0)
    stats.captures += 1
    stats.capture_s += time.perf_counter() - t0
    stats.static_bytes += sum(t.nbytes for t in (i, *static_c, *static_o))
    return _Graph(graph, i, static_c, static_o, flag,
                  [x for x in launches if x[1] or x[2]])


def _replay_chunks(key, n: int, k: int, step, carried: tuple, tensors: list):
    """:func:`_chunks` on the card: the graph of ``key``, ``n``, ``k`` and
    the inputs' shapes, captured at its first call; returns ``(i,
    carried)``, ``i`` the graph's own counter (the next replay overwrites
    it)."""
    key = (key, n, k, tuple((tuple(x.shape), x.dtype, x.device) for x in (*carried, *tensors)))
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = _capture(n, k, step, carried, tensors)
    g.i.zero_()
    for s, t in zip((*g.carried, *g.operands), (*carried, *tensors)):
        s.copy_(t)
    for c in range(math.ceil(n / k)):
        g.graph.replay()
        stats.replays += 1
        for f, dn, ds in g.launches:
            f.launches += dn
            if ds:
                f.by_shape.update(ds)
        if (c + 1) * k >= n or not _read(g.flag):
            break
    return g.i, tuple(t.clone() for t in g.carried)
