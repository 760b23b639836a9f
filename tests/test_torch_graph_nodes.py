"""A switch and a masked loop as a CUDA graph runs them: decided on the
device, with no host read (``utils/control.py``: IF and WHILE nodes of a
:func:`~structure_from_motion_tpu_torch.utils.control.graphed` capture,
``csrc/graph_cond.cu``; on the CPU, :func:`control.device_form`).

A toy with the engine's shapes of control flow: a switch whose branches
hold masked loops of their own shapes (as the PnP rungs hold their LM
loops), a switch nested in a branch, a fixed loop holding a masked loop (as
PnP's LO rounds hold the LM) and a loop that runs to its cap. Here the
device form gives the eager call's bits and refuses a branch that writes
into an operand; on the card a graphed call replays IF and WHILE nodes with
the eager bits, reads the host nowhere, and credits the launches and loop
chunks the device counted.

The file imports nothing of the JAX package, so the card's test runs it on
its own: ``python -m pytest --noconftest -p no:cacheprovider -q
tests/test_torch_graph_nodes.py`` (here its ``cuda`` test skips).
"""

import functools

import numpy as np
import pytest
import torch

from structure_from_motion_tpu_torch.utils import control


def _halving(active, x, y, floor):
    """Each active row halves its distance to y until its step is below
    floor (rows stop at different steps, some at the cap)."""
    new = 0.5 * (x + y)
    x = torch.where(active[:, None], new, x)
    return active & ((new - y).abs().sum(-1) > floor), x


def _thirds(active, x, y, floor):
    new = (2.0 * x + y) / 3.0
    x = torch.where(active[:, None], new, x)
    return active & ((new - y).abs().sum(-1) > floor), x


def _start(x):
    return torch.ones(x.shape[0], dtype=torch.bool, device=x.device), x


def _near(x, y, floor, index):
    return x - y, control.masked_loop(12, 4, _thirds, _start(x), y, floor)[1]


def _far(x, y, floor, index):
    return control.masked_loop(40, 8, _halving, _start(x), y, floor)[1], x * 2.0


def _rows(x, y, floor, index):
    """Half the rows through a loop of their own shapes, then a switch
    nested in this branch."""
    h = x.shape[0] // 2
    part = control.masked_loop(30, 10, _halving, _start(x[:h]), y[:h], floor)[1]
    inner = control.switch(index % 2, [lambda a, b: (a + b,), lambda a, b: (a * b,)], part, y[:h])
    return torch.cat([inner[0], x[h:]]), y + 1.0


def _round(i, x, y, floor):  # a fori body holding a masked loop
    _, x = control.masked_loop(25, 10, _halving, _start(x), y, floor)
    return (x * 1.5 + y,)


def _toy(x, y, floor, index):
    a, b = control.switch(index, [_near, _far, _rows], x, y, floor, index)
    (c,) = control.fori(2, _round, (a,), y, floor)
    _, d = control.masked_loop(100, 10, _halving, _start(b), y, floor)  # may run to its cap
    return c, d, b


def _inputs(seed: int, device="cpu"):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(8, 3)) * 10.0 ** np.arange(8)[:, None]).astype(np.float32)
    y = rng.normal(size=(8, 3)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


@pytest.mark.parametrize("floor", [1e-3, 0.0])  # 0: most loops run to their cap
@pytest.mark.parametrize("index", [0, 1, 2])
def test_the_device_form_gives_the_eager_bits(index, floor):
    """Every branch run and the indexed one's outputs selected, every loop
    run to its cap: the eager call's bits, and no stop mask read."""
    x, y = _inputs(index)
    args = (x, y, torch.tensor(floor), torch.tensor(index))
    control.reset_stats()
    want = _toy(*args)
    assert control.stats.reads > 0
    control.reset_stats()
    with control.device_form():
        got = _toy(*args)
    assert control.stats.reads == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a_branch_writing_into_an_operand_is_refused():
    """Run on the device, every branch runs whatever the index: a branch
    that writes into an operand would change what the taken one sees."""
    def writes(x, y):
        y.add_(1.0)
        return (x + y,)

    x, y = _inputs(0)
    with control.device_form(), pytest.raises(ValueError, match="writes into an operand"):
        control.switch(torch.tensor(0), [lambda a, b: (a - b,), writes], x, y)
    assert torch.equal(control.switch(torch.tensor(1), [lambda a, b: (a - b,), writes], x,
                                      y.clone())[0], x + (y + 1.0))  # eagerly it runs


def test_a_served_cond_runs_as_the_switch():
    """``served_cond`` (an exported cond node) eagerly and in the device
    form: the branch ``pred`` names."""
    x, y = _inputs(1)
    branches = (lambda a, b: (a + b,), lambda a, b: (a * b,))
    for pred in (True, False):
        want = branches[0 if pred else 1](x, y)
        got = control.served_cond(torch.tensor(pred), *branches, (x, y))
        with control.device_form():
            dev = control.served_cond(torch.tensor(pred), *branches, (x, y))
        assert torch.equal(got[0], want[0]) and torch.equal(dev[0], want[0])


@pytest.mark.cuda
def test_graphed_conditional_nodes_give_the_eager_bits():
    """On the card: the toy through ``control.graphed`` (the first call
    runs every branch and loop once in the device form and captures, every
    call replays; with no dict to keep the graph in it raises) for each
    branch, with loops that stop early and at their cap: the eager
    call's bits; no host read, the capture's included; once the device's
    counts are settled, the loop chunks the eager call replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: IF and WHILE nodes run only on the card")
    dev = torch.device("cuda")
    fn = functools.partial(_toy)
    cases = [(0, 1e-3), (1, 1e-3), (2, 1e-3), (1, 0.0), (2, 0.0), (0, 0.0), (2, 1e-3)]
    graphs: dict = {}
    for call, (index, floor) in enumerate(cases):
        x, y = _inputs(call, dev)
        args = (x, y, torch.tensor(floor, device=dev), torch.tensor(index, device=dev))
        control.reset_stats()
        want = _toy(*args)
        eager = control.LoopStats(**vars(control.stats))
        control.reset_stats()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = control.graphed(fn, *args, calls=graphs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        control.settle()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (index, floor)
        assert control.stats.reads == 0 and control.stats.call_replays == 1
        assert control.stats.call_captures == (call == 0)
        # (the first call's pass in the device form, before its capture, replays none)
        assert control.stats.replays == eager.replays, (index, floor)
    assert control.stats.call_nodes == 0 < len(graphs)
    with pytest.raises(ValueError, match="dict of graphs"):
        control.graphed(fn, *args)
