"""Control flow that runs eagerly in the live engine, stays on the device
inside a CUDA graph capture, and stays in the graph when a frame program is
exported (``serve.py``).

The JAX package picks a frame's stage and its bucket sizes with
``lax.switch`` and runs its LM refinements as ``while_loop``s, all inside
one compiled program. Here:

* :func:`switch` picks one of several branches by an index. Eagerly it
  reads a tensor index once on the host and runs only that branch (a
  Python int costs no read). Inside a CUDA graph capture each branch is
  captured into an IF node on ``index == r``, decided on the device. While
  ``torch.export`` traces, it becomes a balanced tree of ``cond`` nodes,
  each making one host read when the exported program runs (``serve.py``
  points them at :func:`served_cond`, which does as :func:`switch` does).
* :func:`loop` is a ``while`` loop over a tuple of tensors: eagerly a
  Python ``while`` with one host read a test; while exporting a
  ``while_loop`` node.
* :func:`fori` is a loop of a fixed trip count (the JAX package's
  ``fori_loop`` and ``scan``): eagerly, and inside a capture, a Python
  ``for`` (no host read); while exporting a ``while_loop`` node whose body
  is traced once, not once an iteration. An exported program's size, and
  its export, save and load times, follow the number of traced operators.
* :func:`masked_loop` is the JAX package's convergence ``while_loop`` (the
  LM and PCG loops): a step that updates only the problems its device-side
  mask leaves active, the mask read on the host once every ``k`` steps. On
  the card each chunk of ``k`` steps is one CUDA graph replay, and inside a
  capture the whole loop is one WHILE node whose body is a chunk, stopped
  on the device; on the CPU the chunk runs eagerly; while exporting it is a
  ``while_loop`` of masked steps. :func:`masked_loop_reference`, one step
  and one host read at a time, is its plain version.
* :func:`graphed` runs a stretch of a frame as one CUDA graph replay: a
  steady frame (``models/incremental.py``), switches and loops included,
  with no host read.

The conditional nodes come from ``csrc/graph_cond.cu``. Which launches a
replay made, and how many chunks each loop ran, the device counts; the
counts reach the host in the frame's grouped metric fetch
(:func:`pending_counts`, :func:`settle`), not by a read of their own.

:func:`device_form` holds the graph's semantics where there is no card: in
it :func:`switch` runs every branch and selects the outputs by the index on
the device, and :func:`masked_loop` runs every chunk to ``n``, neither
reading the host. The CPU tests run the engine in it; nothing on the card
does.

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
import ctypes
import dataclasses
import functools
import math
import time

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree

from structure_from_motion_tpu_torch.utils import profiling


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
    if torch.is_tensor(val):
        out.select(dim, i).copy_(val.to(t.dtype))
    else:  # a fill: copying a Python scalar would upload it, waiting for the card
        out.select(dim, i).fill_(val)
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


def _dense_strides(shape) -> tuple:
    """The strides of a row-major tensor of ``shape``, size-1 axes included
    (``cond`` merges its branches' outputs by these; ``is_contiguous``
    ignores the stride of a size-1 axis)."""
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= n
    return tuple(reversed(strides))


def _fresh(outputs, inputs) -> tuple:
    """The outputs of a cond branch or loop body as an exported program
    needs them: dense tensors that share no storage with its inputs or with
    one another. An output that is so already is returned as it is; any
    other is copied in row-major order (an unchanged state field is the
    input itself, a store's slice of its dump-row buffer is not dense). The
    data stay as they are. A copy costs its launch and its bytes at every
    run of the branch or body (a loop body's copies sit in each CUDA graph
    chunk of its loop), so none is made that the export does not need."""
    seen = {StorageWeakRef(t.untyped_storage()) for t in inputs if torch.is_tensor(t)}
    out = []
    for x in outputs:
        if StorageWeakRef(x.untyped_storage()) in seen or x.stride() != _dense_strides(x.shape):
            x = x.clone(memory_format=torch.contiguous_format)
        seen.add(StorageWeakRef(x.untyped_storage()))
        out.append(x)
    return tuple(out)


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


# -- where a switch or loop runs: eagerly, captured, or in a form of its own ---

_FORM = None  # None or "device" (device_form)


@contextlib.contextmanager
def device_form():
    """Run :func:`switch` and :func:`masked_loop` in the block as a CUDA
    graph runs them, with no host read, on any device: a switch runs every
    branch and takes each output from the branch its index names
    (``torch.where`` on the device), a masked loop runs every chunk to
    ``n``. The results are the eager ones, bit for bit, where every branch
    leaves its operands as they are and a step past a loop's stop changes
    nothing; a branch that writes into an operand raises. The CPU tests
    hold the engine to that here, where no graph can be captured, and
    :func:`graphed` runs its pass before a capture in it."""
    global _FORM
    saved, _FORM = _FORM, "device"
    try:
        yield
    finally:
        _FORM = saved


def _form(t: torch.Tensor):
    """How a switch or loop on the device of ``t`` runs: "capture" inside a
    CUDA graph capture, else the form set (:func:`device_form`), else None
    (eagerly)."""
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        return "capture"
    return _FORM


def switch(index, branches, *operands):
    """``branches[index](*operands)``. Every branch returns the same
    structure of tensors (same shapes and dtypes); ``index`` is a Python
    int or a 0-dim integer tensor in ``[0, len(branches))``. A Python int
    runs its branch; a tensor index is read on the host once eagerly, is
    decided on the device inside a CUDA graph capture (an IF node a
    branch, its outputs copied into the first branch's) and in
    :func:`device_form`, and becomes ``cond`` nodes while exporting.
    Captured or in the device form, every branch must leave its operands
    as they are (checked: a branch that writes into one raises)."""
    if not torch.is_tensor(index):
        return branches[index](*operands)
    if not exporting():
        form = _form(index)
        if form is None:
            return branches[int(index)](*operands)
        if len(branches) == 1:
            return branches[0](*operands)
        index = index.reshape(()).long()
        return _all_branches(form, [functools.partial(torch.eq, index, r)
                                    for r in range(len(branches))], branches, operands)
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
            return _fresh(leaves, (_index, *ts))
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


def served_cond(pred, true_fn, false_fn, operands):
    """An exported ``cond`` node (a :func:`switch`'s) run as the live switch
    runs: eagerly one host read of ``pred`` and the branch it names; inside
    a capture an IF node on ``pred`` and one on its negation; in the device
    form both branches and ``torch.where``. ``true_fn`` and ``false_fn`` are
    the node's branch graphs. Returns the node's outputs."""
    form = _form(pred)
    if form is None:
        return (true_fn if bool(pred) else false_fn)(*operands)
    return _all_branches(form, [lambda: pred, functools.partial(torch.logical_not, pred)],
                         [true_fn, false_fn], tuple(operands))


def _all_branches(form: str, preds: list, branches: list, operands: tuple):
    """Every branch run in ``form``: ``preds[r]()`` gives the device bool of
    branch r. Captured, branch r runs in an IF node on its bool, the first
    branch's outputs (fresh tensors) are the outputs and each later branch
    copies its own into them, as torch's ``cond`` capture does; in the
    device form each later branch's outputs replace them where its bool
    holds."""
    inputs = [t for t in pytree.tree_leaves(operands) if torch.is_tensor(t)]
    out, spec, meta = None, None, None
    for pred, fn in zip(preds, branches):
        versions = [t._version for t in inputs]
        with _if_body(pred(), _label(fn)) if form == "capture" else contextlib.nullcontext():
            leaves, s = pytree.tree_flatten(fn(*operands))
            if not all(torch.is_tensor(x) for x in leaves):
                raise TypeError("a switch branch must return tensors only")
            if spec is not None and (s != spec or [(x.shape, x.dtype) for x in leaves] != meta):
                raise TypeError("switch branches return different structures, shapes or dtypes")
            spec, meta = s, [(x.shape, x.dtype) for x in leaves]
            if form == "capture":
                if out is None:
                    out = list(_fresh(leaves, inputs))
                else:
                    for o, x in zip(out, leaves):
                        o.copy_(x)
        if any(t._version != v for t, v in zip(inputs, versions)):
            raise ValueError(f"switch branch {_label(fn)} writes into an "
                             "operand: a branch run on the device must leave its operands "
                             "as they are")
        if form == "device":
            out = leaves if out is None else [torch.where(pred(), x, o)
                                              for x, o in zip(leaves, out)]
    return pytree.tree_unflatten(list(out), spec)


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
            return _fresh(body_fn(*xs[:n], *rebuild(xs[n:])), xs)

    with meta.preserve_node_meta(), meta.annotate(tag or {"sfm_loop": None}):
        return tuple(while_loop_op(cond, body, carried, tuple(tensors)))


def fori(n: int, body_fn, carried: tuple, *operands) -> tuple:
    """``for i in range(n): carried = body_fn(i, *carried, *operands)``,
    then ``carried``: ``i`` a Python int eagerly and inside a CUDA graph
    capture (the body captured ``n`` times, inline), a 0-dim int64 tensor
    in an exported program (the body is traced once). ``carried`` and
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
    """What :func:`masked_loop` and :func:`graphed` did since
    :func:`reset_stats`: host reads of the stop mask, the loops' CUDA graph
    captures and replays (a chunk replayed from the host, or run by a WHILE
    node of a graphed call: counted when the device's counts are settled),
    :func:`graphed`'s (``call_``), and for both the captures' seconds, the
    reserved memory they added to the graph pools and the bytes of the
    graphs' static input buffers; for :func:`graphed`'s captures also the
    nodes of the graphs (conditional bodies and child graphs included) and
    the seconds of their instantiation, and the bytes its replays copied
    into their graphs and out of them."""

    reads: int = 0
    captures: int = 0
    capture_s: float = 0.0
    replays: int = 0
    pool_bytes: int = 0
    static_bytes: int = 0
    call_captures: int = 0
    call_replays: int = 0
    call_nodes: int = 0
    instantiate_s: float = 0.0
    copy_bytes: int = 0


stats = LoopStats()
_GRAPHS: dict = {}  # key of a call site and its shapes -> _Graph
_POOLS: dict = {}  # device -> the graph memory pool every loop capture shares


def reset_stats() -> None:
    """Set every field of :data:`stats` to 0 (the graphs stay)."""
    for f in dataclasses.fields(stats):
        setattr(stats, f.name, f.default)


_READ_SPANS = ["loop.read"]  # the span of a stop-mask read, named by the innermost caller


@contextlib.contextmanager
def reads_named(name: str):
    """Name the span of each host read of a stop mask in the block
    (``utils/profiling.span``; "loop.read" elsewhere): ``pcg.read`` in
    ``ops/linalg.pcg_solve``."""
    _READ_SPANS.append(name)
    try:
        yield
    finally:
        _READ_SPANS.pop()


def _read(flag: torch.Tensor) -> bool:
    stats.reads += 1
    with profiling.span(_READ_SPANS[-1]):
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
    * inside a CUDA graph capture (:func:`graphed`): ONE conditional WHILE
      node whose body is one chunk, captured on buffers of the carried
      tensors (copied in before the node), with the condition ``any(active)
      and fewer than n steps`` set on the device after each chunk
      (``csrc/graph_cond.cu``);
    * with ``capture=False`` (an all-reduce through gloo in the step cannot
      be captured: the sharded PCG), and on the CPU, the chunks run
      eagerly; in :func:`device_form` every chunk runs, with no read;
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
    returning the step's key) is given, and inside a capture one WHILE node
    over that graph; else eagerly. In :func:`device_form` every chunk runs
    eagerly, with no read."""
    k = -(-n // -(-n // k))
    form = _form(carried[0])
    if form == "capture":
        if graph_key is None:
            raise RuntimeError("a masked loop with capture=False runs inside a CUDA graph capture")
        return _while_chunks(n, k, step, i, carried, tensors)
    if form is None and graph_key is not None and carried[0].is_cuda:
        return _replay_chunks(graph_key(), n, k, step, carried, list(tensors))
    done = 0
    while True:
        for _ in range(k):
            i, carried = step(i, carried, tensors)
        done += k
        if done >= n or (form is None and not _read(carried[0].any())):
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


def _take_back(before: list, wrappers) -> list:
    """The launches the wrappers counted since ``before`` (their
    :func:`_launch_counts`), put back: nothing ran, a capture recorded them.
    Returns ``(wrapper, launches, by shape)`` of each that counted some."""
    launches = []
    for (f, n0, s0), (_, n1, s1) in zip(before, _launch_counts(wrappers)):
        launches.append((f, n1 - n0, s1 - s0))
        f.launches = n0
        if hasattr(f, "by_shape"):
            f.by_shape.clear()
            f.by_shape.update(s0)
    return [x for x in launches if x[1] or x[2]]


def _capture(n: int, k: int, step, carried: tuple, tensors: list) -> _Graph:
    """Warm one chunk of ``step`` up on a side stream, then capture it into
    a graph of the shared pool; the launches the capture counted become the
    graph's."""
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
    graph = torch.cuda.CUDAGraph()
    flag, launches = _counted_capture(dev, graph, chunk)
    stats.captures += 1
    stats.capture_s += time.perf_counter() - t0
    stats.static_bytes += sum(t.nbytes for t in (i, *static_c, *static_o))
    return _Graph(graph, i, static_c, static_o, flag, launches)


def _credit(launches, times: int = 1) -> None:
    """Add a replayed graph's kernel launches, ``times`` over, to their
    wrappers' counts."""
    for f, dn, ds in launches:
        f.launches += dn * times
        if ds:
            f.by_shape.update({shape: m * times for shape, m in ds.items()})


def _counted_capture(dev, graph, body, pool=None):
    """``body()`` captured into ``graph`` (``pool``, by default the pool the
    loops' graphs share; no host synchronisation allowed) -> (its result,
    the launches the capture counted outside conditional bodies, which go
    back to the wrappers' counts: the graph keeps them)."""
    from structure_from_motion_tpu_torch import kernels

    wrappers = kernels.counters()
    before = _launch_counts(wrappers)
    if pool is None:
        if dev not in _POOLS:
            _POOLS[dev] = torch.cuda.graph_pool_handle()
        pool = _POOLS[dev]
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        reserved = torch.cuda.memory_reserved(dev)
        with _sync_errors():
            out = body()
        stats.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
    return out, _take_back(before, wrappers)


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
        _credit(g.launches)
        if (c + 1) * k >= n or not _read(g.flag):
            break
    return g.i, tuple(t.clone() for t in g.carried)


def _while_chunks(n: int, k: int, step, i, carried: tuple, tensors: list):
    """:func:`_chunks` inside a capture: ONE WHILE node (``csrc/graph_cond.cu``)
    whose body, captured here on the stream of its nesting depth, is one
    chunk of ``k`` steps on buffers of the carried tensors (copied in
    before the node), and which runs again while a problem is active and
    fewer than ``n`` steps ran, as the device decides after each chunk.
    Returns ``(steps run, carried)`` (the buffers, written by the node); the
    steps go to the device's count of the call's loop chunks."""
    from structure_from_motion_tpu_torch import kernels

    dev = carried[0].device
    lib = kernels.library()
    static_c = [t.clone() for t in carried]
    steps = (i.clone() if torch.is_tensor(i) else torch.full((), i, dtype=torch.long, device=dev))
    stream, pool = _body_stream(dev, len(_OPEN))
    rec = _RECORDING[-1] if _RECORDING else None
    j, before = rec.begin() if rec is not None else (None, None)
    handle, body = ctypes.c_ulonglong(0), ctypes.c_void_p()
    kernels.check(lib.sfm_begin_while(kernels.stream_ptr(dev), stream.cuda_stream,
                                      ctypes.addressof(handle)), "sfm_begin_while")
    _OPEN.append(_Body("WHILE", _label(step), stream, pool))
    flag = None
    try:
        with torch.cuda.stream(stream), torch.cuda.use_mem_pool(pool, dev):
            c = tuple(static_c)
            s = steps
            for _ in range(k):
                s, c = step(s, c, tensors)
            steps.copy_(s)
            for b, t in zip(static_c, c):
                b.copy_(t)
            flag = c[0].any()
    finally:
        _OPEN.pop()
        if flag is None:  # the body failed: end its capture, the error follows
            lib.sfm_end_capture(stream.cuda_stream, ctypes.addressof(body))
    kernels.check(lib.sfm_end_while(stream.cuda_stream, handle.value, flag.data_ptr(),
                                    steps.data_ptr(), n, ctypes.addressof(body)), "sfm_end_while")
    if rec is not None:
        rec.end(j, before, per=k)
        rec.counts.narrow(0, j, 1).copy_(steps.reshape(1))
        rec.body(f"WHILE {_label(step)}", body.value, 1)  # with the node
    return steps, tuple(static_c)


# -- the regions of a captured call that run as the device decides ---------------

_MAX_REGIONS = 1024  # IF bodies and WHILE nodes a graphed call may hold
_BODY_DEPTHS = 4  # nested conditional bodies a capture is ready for
_RECORDING: list = []  # the _Recorder of the graphed call being captured
_BODIES: dict = {}  # (device, depth) -> (stream, pool) of the conditional bodies at that depth
_OPEN: list = []  # the _Body of each conditional body being captured, innermost last


class _Recorder:
    """The IF bodies and WHILE nodes of a :func:`graphed` call's capture:
    each has a slot of ``counts`` (zeroed at the start of every replay; an
    IF body sets its slot to 1, a WHILE node's steps are written after it)
    and the launches one run of its body makes, taken out of the capture's
    own count. After a replay the host credits ``counts`` times those
    launches when the counts reach it (:func:`settle`). ``nodes`` counts
    the bodies' nodes, ``bodies`` tallies each body's by type."""

    def __init__(self, dev):
        from structure_from_motion_tpu_torch import kernels

        self.wrappers = kernels.counters()
        self.counts = torch.zeros(_MAX_REGIONS, dtype=torch.long, device=dev)
        self.regions: list = []  # (launches, steps a chunk or None for an IF body)
        self.nodes = 0
        self.bodies: list = []  # (label, node counts by type) of each conditional body

    def _slot(self) -> int:
        if len(self.regions) == _MAX_REGIONS:
            raise RuntimeError(f"a graphed call holds more than {_MAX_REGIONS} conditional nodes")
        self.regions.append(None)
        return len(self.regions) - 1

    def begin(self) -> tuple:
        return self._slot(), _launch_counts(self.wrappers)

    def ran(self, j: int) -> None:  # captured inside body j
        self.counts.narrow(0, j, 1).fill_(1)

    def end(self, j: int, before: list, per=None) -> None:
        """Region j's capture ended: the launches counted since ``before``
        are a run's (an IF body's; with ``per``, a WHILE body's, which runs
        once every ``per`` steps)."""
        self.regions[j] = (_take_back(before, self.wrappers), per)

    def body(self, label: str, graph: int, extra: int) -> None:
        """A conditional body's graph was captured: its nodes by type (and
        ``extra`` nodes of the parent: the node and its condition's kernel)
        count in the call's; the tally names the body if the graph is
        refused."""
        types = _node_types(graph)
        self.nodes += sum(types) - types[14] + extra
        self.bodies.append((label, types))


# node types of a graph (cudaGraphNodeType) that a conditional body may hold:
# kernel, memcpy, memset, empty, conditional (CUDA 12.8's runtime reads no
# conditional node's type: one counts as "unreadable")
_BODY_TYPES = (0, 1, 2, 5, 13, 15)
_TYPE_NAMES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "child graph", 5: "empty",
               6: "event wait", 7: "event record", 8: "semaphore signal", 9: "semaphore wait",
               10: "mem alloc", 11: "mem free", 12: "batch memop", 13: "conditional",
               14: "memcpy off the device", 15: "unreadable"}


def _node_types(graph: int) -> list:
    """The nodes of ``graph`` (a ``cudaGraph_t``) by type: 16 counts,
    indexed as :data:`_TYPE_NAMES`."""
    from structure_from_motion_tpu_torch import kernels

    counts = (ctypes.c_longlong * 16)()
    kernels.check(kernels.library().sfm_graph_node_types(graph, ctypes.addressof(counts)),
                  "sfm_graph_node_types")
    return list(counts)


def _label(fn) -> str:
    """A switch branch's or a loop step's name (partials unwrapped)."""
    while isinstance(fn, functools.partial):
        if fn.func is _live_step:
            fn = fn.args[1]
        elif fn.func is _body_step:
            fn = fn.args[0]
        else:
            fn = fn.func
    return getattr(fn, "__qualname__", None) or type(fn).__name__


def _body_stream(dev, depth: int) -> tuple:
    """(stream, memory pool) of a conditional body captured at nesting
    ``depth`` on ``dev``: a stream of its own (a capture cannot share one), made once
    with its cuBLAS and cuSOLVER state (which a capture cannot make), and a
    pool of its own (torch routes a capturing stream's allocations to one
    pool; the frame's capture holds another). Bodies at one depth run one
    after another, so they share both; none runs beside another graph."""
    from structure_from_motion_tpu_torch import kernels

    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    key = (dev, depth)
    if key not in _BODIES:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"IF bodies nested {depth + 1} deep: make their streams before the "
                               "capture")
        ptr = ctypes.c_void_p()
        kernels.check(kernels.library().sfm_stream_create(ctypes.addressof(ptr)),
                      "sfm_stream_create")
        stream = torch.cuda.ExternalStream(ptr.value, device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            a = torch.eye(7, device=dev).expand(2, 7, 7) * 2.0
            torch.linalg.solve_ex(a @ a, a)
            torch.linalg.inv_ex(a)
        torch.cuda.current_stream(dev).wait_stream(stream)
        _BODIES[key] = (stream, torch.cuda.MemPool())
    return _BODIES[key]


@dataclasses.dataclass
class _Body:
    """A conditional body being captured: an IF body (``pred`` its device
    bool) or a WHILE body, on the stream and pool of its nesting depth."""

    kind: str
    label: str
    stream: object
    pool: object
    pred: torch.Tensor | None = None
    ctx: contextlib.ExitStack | None = None  # the stream and pool the body captures on
    region: tuple | None = None  # (slot, launch counts before) in the recorder


def _enter(b: _Body) -> None:
    """Open a new IF node on ``b.pred`` in what the current stream captures
    into, and capture what follows into its body (``csrc/graph_cond.cu``)."""
    from structure_from_motion_tpu_torch import kernels

    dev = b.pred.device
    rec = _RECORDING[-1] if _RECORDING else None
    b.region = rec.begin() if rec is not None else None
    kernels.check(kernels.library().sfm_capture_if(kernels.stream_ptr(dev), b.stream.cuda_stream,
                                                   b.pred.data_ptr()), "sfm_capture_if")
    b.ctx = contextlib.ExitStack()
    b.ctx.enter_context(torch.cuda.stream(b.stream))
    b.ctx.enter_context(torch.cuda.use_mem_pool(b.pool, dev))
    _OPEN.append(b)


def _leave(b: _Body, ran: bool = True) -> None:
    """End the capture of IF body ``b`` (the innermost open); with ``ran``
    its region's device count is set in the body first."""
    from structure_from_motion_tpu_torch import kernels

    rec = _RECORDING[-1] if _RECORDING else None
    if ran and rec is not None:
        rec.ran(b.region[0])
    _OPEN.pop()
    b.ctx.close()
    body = ctypes.c_void_p()
    kernels.check(kernels.library().sfm_end_capture(b.stream.cuda_stream, ctypes.addressof(body)),
                  "sfm_end_capture")
    if rec is not None:
        rec.end(*b.region)
        rec.body(f"IF {b.label}", body.value, 2)  # with the condition's kernel and the node


@contextlib.contextmanager
def _if_body(pred: torch.Tensor, label: str = ""):
    """Capture the block into the body of an IF node on the device bool
    ``pred``: the block's operations run only where ``pred`` holds when the
    graph runs. Inside a :func:`graphed` capture the body is a region of
    its recorder (``label`` names it). :func:`unconditional` may close the
    body and open another on the same ``pred`` within the block."""
    stream, pool = _body_stream(pred.device, len(_OPEN))
    b = _Body("IF", label, stream, pool, pred.reshape(()).to(torch.bool).contiguous())
    _enter(b)
    ran = False
    try:
        yield
        ran = True
    finally:
        _leave(b, ran)


def unconditional(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, run inside a CUDA graph capture at the top
    level of the graph, outside every IF body open around the call: the IF
    bodies are closed before it and opened again after it, on the same
    predicates (a switch's branch becomes two IF nodes or more). This is
    for what a conditional body may not hold, a library call that
    allocates in the stream as it runs (cuSOLVER's Cholesky, whose
    workspace comes from the stream's pool: memory nodes). It then runs
    whichever branch the predicates name, on inputs only the taken branch
    wrote (results the other branches never read); ``fn`` must launch no
    kernel of the port's (checked) and may not sit in a loop's body.
    Anywhere else, ``fn(*args, **kwargs)``."""
    if not _OPEN:
        return fn(*args, **kwargs)
    if any(b.kind == "WHILE" for b in _OPEN):
        raise RuntimeError(f"{_label(fn)} cannot leave the body of a loop in a CUDA graph capture")
    from structure_from_motion_tpu_torch import kernels

    bodies = list(_OPEN)
    for b in reversed(bodies):
        _leave(b)
    wrappers = kernels.counters()
    before = _launch_counts(wrappers)
    try:
        out = fn(*args, **kwargs)
    finally:
        for b in bodies:
            _enter(b)
    if _take_back(before, wrappers):
        raise RuntimeError(f"{_label(fn)} launched a kernel of the port outside its branch")
    return out


# -- the device's counts of the conditional regions, read with the metrics -------

_PENDING: list = []  # (regions, device counts) of replays the host has not credited
_MAX_PENDING = 64  # replays left uncredited before :func:`graphed` reads their counts


def pending_counts() -> list:
    """The device counts of the graph replays not credited yet, one tensor a
    replay: a caller that copies tensors to the host (``device.fetch``, the
    frame's grouped metric fetch) copies these with them and hands the
    copies to :func:`settle`."""
    return [counts for _, counts in _PENDING]


def settle(values=None) -> None:
    """Credit the pending replays' conditional regions: each IF body that
    ran adds its launches once, each WHILE node its body's launches and one
    loop replay a chunk it ran. ``values``: host copies of
    :func:`pending_counts` in its order, or None to read them now (one host
    read; none when nothing is pending)."""
    pending = _PENDING[:len(values)] if values is not None else _PENDING[:]
    del _PENDING[:len(pending)]
    if not pending:
        return
    if values is None:
        flat = torch.cat([c for _, c in pending]).tolist()
        values, at = [], 0
        for _, c in pending:
            values.append(flat[at:at + len(c)])
            at += len(c)
    for (regions, _), counts in zip(pending, values):
        for (launches, per), count in zip(regions, counts):
            times = int(count) if per is None else int(count) // per
            if times:
                _credit(launches, times)
            if per is not None:
                stats.replays += times


# -- a stretch of a frame replayed as one CUDA graph ---------------------------


@dataclasses.dataclass
class _Call:
    graph: torch.cuda.CUDAGraph
    inputs: list  # the input buffers: each call's tensors are copied in
    outputs: list  # the graph's output leaves (a replay overwrites them)
    spec: object  # the outputs' tree structure
    aliases: list  # output i is input aliases[i] unchanged (None: made by the graph)
    launches: list  # (wrapper, launches, by shape) of the kernels a replay runs unconditionally
    regions: list  # the _Recorder's regions
    counts: torch.Tensor  # their device counts (a replay rewrites them)
    copy_bytes: int  # copied into the graph and out of it a replay


def graphed(fn, *operands, calls: dict | None = None):
    """``fn(*operands)``: ``operands`` any structure of tensors and constants,
    ``fn`` returning a structure of tensors made from them alone, with no
    host read but those of its switches and loops (the constants it closes
    over and the operands' Python values key it).

    On CUDA tensors the first call of a key (``fn``'s code and constants,
    the constant operands, the tensors' shapes and dtypes) runs ``fn`` once
    in :func:`device_form` (every branch of its switches and every chunk of
    its loops on these inputs, no host read, results thrown away: what a
    capture cannot make, library handles and workspaces and kernels' first
    launches, then exists), then captures ``fn`` on copies of its tensors
    into a CUDA graph with a memory pool of its own (a failed capture
    raises; a host synchronisation in it raises): each switch with a tensor
    index becomes IF nodes, each masked loop a WHILE node, each
    :func:`fori` and nested :func:`graphed` call runs inline. The graph is
    kept in ``calls``, the caller's dict (an engine's own: dropping the
    engine frees the graphs' pools; a call that would capture without one
    raises). That call and every later one copy their tensors into the
    graph's input buffers and replay it, which adds the launches the
    capture counted outside its conditional nodes to the kernels' counts,
    and leaves the device's count of the conditional ones to
    :func:`pending_counts`. An output that is an input unchanged is returned
    as that input; every other is a copy of the graph's buffer, so the next
    replay overwrites nothing the caller holds. On the CPU, while
    ``torch.export`` traces, in :func:`device_form` and inside another
    capture, ``fn`` runs as it is."""
    tensors, rebuild = _split(operands)
    if (exporting() or not tensors or not tensors[0].is_cuda or _FORM is not None
            or torch.cuda.is_current_stream_capturing()):
        return fn(*operands)
    if calls is None:
        raise ValueError(f"graphed({_label(fn)}) on the card needs the caller's dict of graphs")
    leaves, spec = pytree.tree_flatten(operands)
    key = (_const_key(fn), spec, tuple(_const_key(x) for x in leaves if not torch.is_tensor(x)),
           tuple((tuple(t.shape), t.dtype, t.device) for t in tensors))
    call = calls.get(key)
    if call is None:
        inputs = [t.clone() for t in tensors]
        with device_form():
            fn(*operands)
        call = calls[key] = _capture_call(fn, rebuild, inputs)
    for buf, t in zip(call.inputs, tensors):
        buf.copy_(t)
    call.graph.replay()
    stats.call_replays += 1
    stats.copy_bytes += call.copy_bytes
    _credit(call.launches)
    if call.regions:
        if len(_PENDING) >= _MAX_PENDING:
            settle()
        _PENDING.append((call.regions, call.counts.clone()))
    out = [tensors[a] if a is not None else t.clone()
           for t, a in zip(call.outputs, call.aliases)]
    return pytree.tree_unflatten(out, call.spec)


def _capture_call(fn, rebuild, inputs: list) -> _Call:
    """:func:`graphed`'s capture of ``fn`` on the input buffers ``inputs``
    (its pass in the device form ran just before) into a pool of its own,
    kept as a ``cudaGraph_t`` (its nodes are counted, and named when the
    graph is refused)."""
    dev = inputs[0].device
    t0 = time.perf_counter()
    for depth in range(_BODY_DEPTHS):
        _body_stream(dev, depth)
    rec = _Recorder(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)

    def body():
        rec.counts.zero_()
        return fn(*rebuild(inputs))

    _RECORDING.append(rec)
    try:
        out, launches = _counted_capture(dev, graph, body, torch.cuda.graph_pool_handle())
    finally:
        _RECORDING.pop()
    top = _node_types(graph.raw_cuda_graph())
    t1 = time.perf_counter()
    try:
        graph.instantiate()
    except Exception as e:
        refused = [(label, {_TYPE_NAMES[t]: c for t, c in enumerate(types)
                            if c and (t not in _BODY_TYPES)})
                   for label, types in rec.bodies]
        raise RuntimeError(f"the CUDA graph of {_label(fn)} was refused ({e}); conditional "
                           f"bodies holding nodes a body may not hold: "
                           f"{[r for r in refused if r[1]]}; the graph's nodes by type "
                           f"{ {_TYPE_NAMES[t]: c for t, c in enumerate(top) if c} }") from e
    stats.instantiate_s += time.perf_counter() - t1
    nodes = rec.nodes + sum(top) - top[14]
    outputs, spec = pytree.tree_flatten(out)
    if not all(torch.is_tensor(x) for x in outputs):
        raise TypeError("a graphed function must return tensors only")
    owner = {(t.data_ptr(), t.shape, t.stride(), t.dtype): i for i, t in enumerate(inputs)}
    aliases = [owner.get((t.data_ptr(), t.shape, t.stride(), t.dtype)) for t in outputs]
    stats.call_captures += 1
    stats.call_nodes += nodes
    stats.capture_s += time.perf_counter() - t0
    stats.static_bytes += sum(t.nbytes for t in inputs)
    copy_bytes = sum(t.nbytes for t in inputs) + sum(
        t.nbytes for t, a in zip(outputs, aliases) if a is None)
    return _Call(graph, inputs, outputs, spec, aliases, launches, rec.regions,
                 rec.counts[:len(rec.regions)], copy_bytes)
