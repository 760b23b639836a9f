"""A served program runs its loops as the live engine does
(``serve.retarget_loops``, ``utils/control.served_fori`` and
``served_masked_loop``).

A toy program with the three loop shapes of the engine's frame programs
(a masked loop, a fixed loop whose body holds a masked loop, as PnP's LO
rounds hold the LM, and a masked loop in a ``switch`` branch, as the BA's
LM sits under its bucket choice) is exported under ``export_engine``'s
tracing context, saved, loaded and retargeted: it gives the eager call's
bits and the eager call's host reads, and no loop predicate is run. An
untagged ``while_loop`` is refused.

The file imports nothing of the JAX package, so the card's test runs it
on its own: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_serve_loops.py`` (there the graph test captures and
replays CUDA graphs; here it skips).
"""

import io
import zipfile

import numpy as np
import pytest
import torch

from structure_from_motion_tpu_torch import serve
from structure_from_motion_tpu_torch.utils import control


def _halving(active, x, y, floor):
    """Each active row halves its distance to y until its step is below
    floor (rows stop at different steps, some at the cap)."""
    new = 0.5 * (x + y)
    x = torch.where(active[:, None], new, x)
    return active & ((new - y).abs().sum(-1) > floor), x


def _start(x):
    return torch.ones(x.shape[0], dtype=torch.bool, device=x.device), x


def _round(i, x, y, floor):  # a fori body holding a masked loop
    _, x = control.masked_loop(25, 10, _halving, _start(x), y, floor)
    return (x * 1.5 + y,)


def _far(x, y, floor):
    return control.masked_loop(40, 8, _halving, _start(x), y, floor)[1]


def _near(x, y, floor):
    return x - y


class _Loops(torch.nn.Module):
    def forward(self, x, y, floor, index):
        _, a = control.masked_loop(50, 10, _halving, _start(x), y, floor)
        (b,) = control.fori(3, _round, (x,), y, floor)
        c = control.switch(index, [_near, _far], x, y, floor)
        return a, b, c


def _inputs(device="cpu"):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 3)).astype(np.float32) * 10.0 ** np.arange(6)[:, None]
    y = rng.normal(size=(6, 3)).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device),
            torch.tensor(1e-3, device=device))


def _served(module, args):
    """``module`` exported and saved as ``export_engine`` does it, loaded and
    retargeted; returns (program, loop nodes retargeted)."""
    blob, _, _ = serve.export_program(module, args)
    program = torch.export.load(io.BytesIO(blob)).module()
    return program, serve.retarget_loops(program)


def _loop_conds(program):
    """The condition graphs of the retargeted loop nodes."""
    conds = []
    for _, gm in program.named_modules():
        if isinstance(gm, torch.fx.GraphModule):
            conds += [getattr(gm, n.args[0].target) for n in gm.graph.nodes
                      if n.target in (control.served_fori, control.served_masked_loop)]
    return conds


def _never(*args):
    raise AssertionError("a served loop ran its predicate")


def _check(device):
    """Served against eager on ``device``: bits, host reads, no predicate
    run; returns the stats of the served calls."""
    x, y, floor = _inputs(device)
    program, count = _served(_Loops(), (x, y, floor, torch.tensor(1, device=device)))
    assert count == 4  # the masked loop, the fori and its masked loop, the branch's
    for cond in _loop_conds(program):
        cond.forward = _never
    served = control.LoopStats()
    for index in (0, 1):
        for scale in (1.0, 1e3):
            control.reset_stats()
            want = _Loops()(x * scale, y, floor, index)  # eagerly: an int index
            reads = control.stats.reads
            control.reset_stats()
            got = program(x * scale, y, floor, torch.tensor(index, device=device))
            assert control.stats.reads == reads > 0, (index, scale)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (index, scale)
            for f in ("reads", "captures", "replays"):
                setattr(served, f, getattr(served, f) + getattr(control.stats, f))
    return served


def test_served_loops_give_the_eager_bits_and_reads():
    """On the CPU the masked chunks run eagerly: the eager call's bits and
    reads, and no loop predicate is run (a fixed loop reads nothing)."""
    stats = _check("cpu")
    assert stats.captures == stats.replays == 0


def test_a_served_fixed_loop_reads_nothing():
    class Fixed(torch.nn.Module):
        def forward(self, x, y):
            return control.fori(4, lambda i, x, y: (x * 0.5 + y * i,), (x,), y)[0]

    x, y, _ = _inputs()
    program, count = _served(Fixed(), (x, y))
    assert count == 1
    (cond,) = _loop_conds(program)
    cond.forward = _never
    control.reset_stats()
    assert torch.equal(program(x, y), Fixed()(x, y))
    assert control.stats.reads == 0


def test_an_untagged_loop_is_refused():
    """A plain ``control.loop`` (and an artifact exported before the tags)
    has an untagged ``while_loop`` node: the served program refuses it,
    naming the re-export, rather than reading its predicate every step."""
    class Untagged(torch.nn.Module):
        def forward(self, x):
            i0 = torch.zeros((), dtype=torch.long)
            return control.loop(lambda i, x: i < 5, lambda i, x: (i + 1, x * 0.5), (i0, x))[1]

    with pytest.raises(ValueError, match="carries no loop tag: export the artifact again"):
        _served(Untagged(), (torch.ones(3),))


def test_loop_tags_reach_the_loaded_program():
    """Each loop node's tag survives save and load (kind, n and, masked, k);
    the artifact holds no other node's ``meta["custom"]``."""
    x, y, floor = _inputs()
    blob, _, _ = serve.export_program(_Loops(), (x, y, floor, torch.tensor(1)))
    program = torch.export.load(io.BytesIO(blob)).module()
    tags = [n.meta["custom"] for _, gm in program.named_modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.target is torch.ops.higher_order.while_loop]
    assert sorted(tuple(t.values()) for t in tags) == [
        ("fori", 3), ("masked", 25, 10), ("masked", 40, 8), ("masked", 50, 10)]
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        graphs = b"".join(z.read(n) for n in z.namelist() if n.endswith(".json"))
    assert graphs.count(b"sfm_loop") == 4 and b"_torchdynamo_disable" not in graphs


@pytest.mark.cuda
def test_served_loops_replay_cuda_graphs():
    """On the card each masked chunk of the served program is one CUDA
    graph replay: the eager call's bits and reads (which replays its own
    graphs), a graph captured once a loop body and shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph path runs only on the card")
    stats = _check("cuda")
    assert stats.captures == 3 and stats.replays >= stats.reads > 0


def _keep_first(x, y, floor):  # x unchanged: an output aliasing an input
    return x, y * 2.0


def _keep_second(x, y, floor):  # y unchanged, and a slice that is not dense
    return (x + 1.0)[:, :2].repeat(1, 2)[:, :3], y


def _fresh_round(i, x, y, floor):  # a body whose outputs are all new tensors
    return x * 0.5 + y + floor, y + 1.0


def _pass_round(i, x, y, floor):  # a body handing one carried tensor on unchanged
    return x * 0.5 + y + floor, y


class _Copies(torch.nn.Module):
    def forward(self, x, y, floor, index):
        a, b = control.switch(index, [_keep_first, _keep_second], x, y, floor)
        c, d = control.fori(2, _fresh_round, (x, y), floor)
        e, f = control.fori(2, _pass_round, (x, y), floor)
        return a, b, c, d, e, f


def _clones(program) -> dict:
    """``{graph path: aten.clone nodes}`` of a loaded program."""
    return {path: sum(n.target is torch.ops.aten.clone.default for n in gm.graph.nodes)
            for path, gm in program.named_modules() if isinstance(gm, torch.fx.GraphModule)}


def test_exported_branches_and_bodies_copy_only_what_aliases():
    """An exported ``switch`` branch or loop body copies an output only where
    it aliases an input (an unchanged operand or carried tensor) or is not
    row-major: each copy is a launch at every run of the branch, and in a
    loop body a kernel in every step of each CUDA graph chunk, which made a
    served frame slower than the live one. The program still gives the
    eager bits for both branches."""
    x, y, floor = _inputs()
    module = _Copies()
    program, _ = _served(module, (x, y, floor, torch.tensor(0)))
    clones = _clones(program)
    bodies = sorted(p for p in clones if "while_loop_body" in p)
    branches = sorted(p for p in clones if p.startswith(("true_graph", "false_graph")))
    assert len(bodies) == 2 and len(branches) == 2
    # one body hands y on unchanged: one copy; the other copies nothing
    assert sorted(clones[p] for p in bodies) == [0, 1]
    # each branch copies its one unchanged input; the slice is made dense
    assert all(clones[p] >= 1 for p in branches)
    assert sum(clones[p] for p in branches) <= 3
    assert clones[""] == 0
    for index in (0, 1):
        got = program(x, y, floor, torch.tensor(index))
        want = module(x, y, floor, torch.tensor(index))
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_loaded_operators_call_their_eager_binding():
    """``serve.eager_calls`` points a loaded program's ATen nodes at the
    eager binding the live engine calls (the boxed ``OpOverload`` call costs
    the host more a call), only where the generated code's name reaches
    that binding and the binding reproduces the node's recorded layout; an
    operator that writes to an input keeps its ``OpOverload``. The bits are
    the eager call's."""
    aten = torch.ops.aten
    assert serve._eager_binding(aten.mul.Tensor) is torch.mul
    assert serve._eager_binding(aten.view.default) is torch.Tensor.view
    assert serve._eager_binding(aten.index_put_.default) is None  # writes to its input
    assert serve._eager_binding(aten.einsum.default) is None  # torch.einsum: a wrapper
    x, y, floor = _inputs()
    module = _Loops()
    args = (x, y, floor, torch.tensor(1))
    program, _ = _served(module, args)
    ops = lambda: [n.target for _, gm in program.named_modules()  # noqa: E731
                   if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
                   if n.op == "call_function"]
    before = ops()
    boxed = sum(isinstance(t, torch._ops.OpOverload) for t in before)
    mutating = [t for t in before if isinstance(t, torch._ops.OpOverload) and t._schema.is_mutable]
    pointed = serve.eager_calls(program)
    assert 0 < pointed <= boxed
    assert sum(isinstance(t, torch._ops.OpOverload) for t in ops()) == boxed - pointed
    assert all(t in ops() for t in mutating)  # an operator writing to an input stays boxed
    for index in (0, 1):
        got = program(x, y, floor, torch.tensor(index))
        want = module(x, y, floor, torch.tensor(index))
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_served_conds_run_as_the_live_switch():
    """``serve.retarget_conds`` points a loaded program's ``cond`` node at
    ``control.served_cond``: the eager bits for either branch; in the
    device form (the CUDA graph's semantics: both branches run on the
    device, no host read) the same bits."""
    x, y, floor = _inputs()
    program, _ = _served(_Loops(), (x, y, floor, torch.tensor(1)))
    assert serve.retarget_conds(program) == 1
    targets = [n.target for _, gm in program.named_modules() if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes]
    assert control.served_cond in targets and torch.ops.higher_order.cond not in targets
    for index in (0, 1):
        want = _Loops()(x, y, floor, index)
        got = program(x, y, floor, torch.tensor(index))
        control.reset_stats()
        with control.device_form():
            dev = program(x, y, floor, torch.tensor(index))
        assert control.stats.reads == 0
        for g, d, w in zip(got, dev, want):
            assert torch.equal(g, w) and torch.equal(d, w), index


def test_copies_of_constants_are_hoisted_to_load():
    """A constant the export lifted and copies at every run (``to`` after
    ``lift_fresh_copy``; on the card a host-to-card upload a run, which no
    CUDA graph can hold) is copied once, at load: the program gives the
    same bits with no ``to`` node left."""
    class Const(torch.nn.Module):
        def forward(self, x):
            return x + torch.tensor([1.0, 2.5, -3.0], dtype=torch.float64).to(x.dtype)

    x = torch.arange(3.0)
    program = torch.export.load(io.BytesIO(serve.export_program(Const(), (x,))[0])).module()
    want = program(x)
    assert serve.hoist_constants(program) == 1
    assert not any(n.target is torch.ops.aten.to.dtype for n in program.graph.nodes)
    assert torch.equal(program(x), want) and torch.equal(want, Const()(x))
