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
