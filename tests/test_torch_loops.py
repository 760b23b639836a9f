"""The port's convergence loops (``utils/control.masked_loop``: a device-side
stop mask read once every k steps) against their plain per-step loop
(``masked_loop_reference``, one host read a step), bit for bit, on seeded
numpy problems whose lanes stop at different steps: PnP's LM
(``ops/pnp._lm_steps``), the triangulation's LM
(``ops/triangulation.refine_triangulate``) and PCG (``ops/linalg.pcg_solve``,
also against the JAX package's ``while_loop``). On the CPU the chunks run
eagerly; the card replays each chunk as a CUDA graph (``chip_smoke.py``
holds that path to the same plain loop)."""

import functools
import io
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.ops.linalg import pcg_solve as jax_pcg_solve
from structure_from_motion_tpu_torch.config import LMConfig
from structure_from_motion_tpu_torch.ops import linalg, pnp, triangulation
from structure_from_motion_tpu_torch.utils import control
from structure_from_motion_tpu_torch.utils.rotations import quat_normalize, quat_to_rotation


def _counted_reference(steps: list):
    """The plain loop, appending the steps it ran to ``steps``."""
    def run(n, k, step_fn, carried, *operands, capture=True):
        def counted(*args):
            steps[-1] += 1
            return step_fn(*args)

        steps.append(0)
        return control.masked_loop_reference(n, k, counted, carried, *operands)
    return run


def _plain(monkeypatch, module, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``module``'s loop the per-step plain
    loop -> (result, steps of each loop it ran)."""
    steps: list = []
    with monkeypatch.context() as m:
        m.setattr(module, "masked_loop", _counted_reference(steps))
        out = fn(*args, **kwargs)
    return out, steps


def _pnp_lanes(seed: int, lanes: int = 4, n: int = 48):
    """Lane b: n points seen by a camera whose start pose is off by a
    perturbation that grows with b (so lanes stop at different steps; the
    last one runs to the cap), 10% of the observations 20-60 px off (the
    Huber case's outliers), 15% masked. In float64: in float32 the squared
    step settles near 1e-12 and no lane reaches the 1e-14 stop."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -2, 6], [3, 2, 12], size=(lanes, n, 3))
    q = rng.normal(size=(lanes, 4)) * [0.05, 1, 1, 1] + [1, 0, 0, 0]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    C = rng.normal(size=(lanes, 3)) * 0.3
    R = quat_to_rotation(torch.as_tensor(q)).numpy()
    x = np.einsum("bji,bnj->bni", R, X - C[:, None])
    meas = x[..., :2] / x[..., 2:] + rng.normal(size=(lanes, n, 2)) * 1e-3
    out = rng.random((lanes, n)) < 0.1
    meas[out] += rng.uniform(0.04, 0.12, size=(int(out.sum()), 2))
    scale = (0.002 * 4.0 ** np.arange(lanes))[:, None]
    q0 = q + rng.normal(size=(lanes, 4)) * scale
    C0 = C + rng.normal(size=(lanes, 3)) * scale * 5
    mask = rng.random((lanes, n)) > 0.15
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    return (quat_normalize(f(q0)), f(C0), f(X), f(meas), torch.as_tensor(mask))


@pytest.mark.parametrize("cap", [25, 100])
@pytest.mark.parametrize("huber", [0.0, 2e-3])
def test_lm_steps_chunked_equals_the_per_step_loop(monkeypatch, cap, huber):
    """``_lm_steps`` on a stack of lanes through the chunked loop: the same
    bits as the per-step loop, for a cap that is no multiple of k (25) and
    one that is (100), with and without Huber; each lane as its own call
    gives; lanes stop at different steps; at most ceil(steps / k) + 1 host
    reads."""
    q0, C0, X, meas, mask = _pnp_lanes(1)
    args = (q0, C0, X, meas, mask)
    kw = dict(iterations=cap, damping=1e-3, huber_delta=huber)
    control.reset_stats()
    got = pnp._lm_steps(*args, **kw)
    reads = control.stats.reads
    want, (steps,) = _plain(monkeypatch, pnp, pnp._lm_steps, *args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    alone = [_plain(monkeypatch, pnp, pnp._lm_steps, *(a[b:b + 1] for a in args), **kw)
             for b in range(q0.shape[0])]
    for b, (out, _) in enumerate(alone):
        assert torch.equal(got[0][b:b + 1], out[0]) and torch.equal(got[1][b:b + 1], out[1])
    lane_steps = [s for _, (s,) in alone]
    assert len(set(lane_steps)) > 1 and max(lane_steps) == steps
    assert reads <= math.ceil(steps / pnp.LM_CHUNK) + 1


def test_lm_steps_one_problem_without_a_lane_axis(monkeypatch):
    """A pose without a lane axis (``refine_pnp``'s call): the same bits."""
    q0, C0, X, meas, mask = (a[2] for a in _pnp_lanes(2))
    kw = dict(iterations=100, damping=5.0)
    got = pnp._lm_steps(q0, C0, X, meas, mask, **kw)
    want, _ = _plain(monkeypatch, pnp, pnp._lm_steps, q0, C0, X, meas, mask, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("cap", [25, 100])
def test_refine_triangulate_chunked_equals_the_per_step_loop(monkeypatch, cap):
    """Three lanes of points seen by two cameras each, started off their
    truth by amounts that grow with the lane: the chunked loop gives the
    per-step loop's bits, and lanes stop at different steps."""
    rng = np.random.default_rng(3)
    lanes, n = 3, 40
    Xw = rng.uniform([-3, -2, 6], [3, 2, 12], size=(lanes * n, 3))
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    P = np.stack([K @ np.hstack([np.eye(3), np.zeros((3, 1))]),
                  K @ np.hstack([np.eye(3), [[-1.0], [0.1], [0.2]]])])
    Xh = np.hstack([Xw, np.ones((lanes * n, 1))])
    proj = np.einsum("vij,nj->nvi", P, Xh)
    uv = proj[..., :2] / proj[..., 2:] + rng.normal(size=(lanes * n, 2, 2)) * 0.5
    om = rng.random((lanes * n, 2)) > 0.1
    off = np.repeat(0.01 * 10.0 ** np.arange(lanes), n)[:, None]
    X0 = np.hstack([Xw + rng.normal(size=Xw.shape) * off, np.ones((lanes * n, 1))])
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    args = (f(P), f(uv), torch.as_tensor(om), f(X0), LMConfig(damping=5.0, iterations=cap))
    control.reset_stats()
    got = triangulation.refine_triangulate(*args, lanes=lanes)
    reads = control.stats.reads
    want, (steps,) = _plain(monkeypatch, triangulation, triangulation.refine_triangulate, *args,
                            lanes=lanes)
    assert torch.equal(got, want)
    lane_steps = [_plain(monkeypatch, triangulation, triangulation.refine_triangulate,
                         args[0], args[1][b * n:(b + 1) * n], args[2][b * n:(b + 1) * n],
                         args[3][b * n:(b + 1) * n], args[4])[1][0] for b in range(lanes)]
    assert len(set(lane_steps)) > 1 and max(lane_steps) == steps
    assert reads <= math.ceil(steps / pnp.LM_CHUNK) + 1


def _spd(seed: int, V: int = 30):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(7 * V, 7 * V))
    A = B @ B.T / (7 * V) + np.diag(rng.uniform(0.05, 5.0, 7 * V))
    b = rng.normal(size=(V, 7))
    Pinv = np.linalg.inv(np.stack([A[7 * v:7 * v + 7, 7 * v:7 * v + 7] for v in range(V)]))
    return A, b, Pinv


def _matvec(x, A, Pinv):
    return (A @ x.reshape(-1)).reshape(x.shape)


def _precond(r, A, Pinv):
    return torch.einsum("vij,vj->vi", Pinv, r)


@pytest.mark.parametrize("cap", [5, 25, 200])
def test_pcg_chunked_equals_the_per_step_loop_and_jax(monkeypatch, cap):
    """Block-Jacobi PCG with its operands passed (as the global solve passes
    them): the iterate and the count of the per-step loop, bit for bit;
    within ``test_pcg_solve_matches_jax``'s tolerance of JAX's
    ``while_loop``; at most ceil(iterations / k) + 1 host reads of the stop
    test (and one of the count)."""
    A, b, Pinv = _spd(0)
    ops = (torch.as_tensor(A), torch.as_tensor(Pinv))
    cg: list = []
    control.reset_stats()
    got = linalg.pcg_solve(_matvec, torch.as_tensor(b), cap, precond=_precond, cg_iters=cg,
                           operands=ops)
    reads = control.stats.reads
    plain_cg: list = []
    want, (steps,) = _plain(monkeypatch, linalg, linalg.pcg_solve, _matvec, torch.as_tensor(b),
                            cap, precond=_precond, cg_iters=plain_cg, operands=ops)
    assert torch.equal(got, want) and cg == plain_cg == [steps]
    assert (steps == cap) == (cap < 25)
    assert reads <= math.ceil(steps / linalg.CG_CHUNK) + 1
    Aj, Pj = jnp.asarray(A), jnp.asarray(Pinv)
    jax_x = jax_pcg_solve(lambda x: (Aj @ x.reshape(-1)).reshape(x.shape), jnp.asarray(b), cap,
                          precond=lambda r: jnp.einsum("vij,vj->vi", Pj, r))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_x), rtol=1e-5, atol=1e-12)


def test_pcg_eager_chunks_when_capture_is_off(monkeypatch):
    """``capture=False`` (the sharded solve's all-reduce) runs the same
    chunks: the same bits and count."""
    A, b, Pinv = _spd(1)
    ops = (torch.as_tensor(A), torch.as_tensor(Pinv))
    cg, cg_off = [], []
    x = linalg.pcg_solve(_matvec, torch.as_tensor(b), 64, precond=_precond, cg_iters=cg,
                         operands=ops)
    x_off = linalg.pcg_solve(_matvec, torch.as_tensor(b), 64, precond=_precond, cg_iters=cg_off,
                             operands=ops, capture=False)
    assert torch.equal(x, x_off) and cg == cg_off


def _halving(active, x, y, floor):
    """Each active entry halves towards y until its step is below floor."""
    new = 0.5 * (x + y)
    x = torch.where(active, new, x)
    return active & ((new - y).abs() > floor), x


class _Masked(torch.nn.Module):
    def forward(self, x, y, floor):
        return control.masked_loop(40, 8, _halving, (torch.ones_like(x, dtype=torch.bool), x),
                                   y, floor)


def test_masked_loop_exports_to_the_eager_results():
    """While exporting, a ``while_loop`` of masked steps: the served
    program gives the eager chunks' bits (and the per-step loop's) on
    inputs whose entries stop at different steps and at the cap."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=6).astype(np.float32) * 10.0 ** np.arange(6))
    y = torch.zeros(6)
    floor = torch.tensor(1e-3)
    with control.export_tracing():
        ep = torch.export.export(_Masked(), (x, y, floor), strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    served = torch.export.load(io.BytesIO(buf.getvalue())).module()
    for scale in (1.0, 1e4):
        want = _Masked()(x * scale, y, floor)
        plain = control.masked_loop_reference(40, 8, _halving, (torch.ones(6, dtype=torch.bool),
                                                                x * scale), y, floor)
        got = served(x * scale, y, floor)
        for g, w, p in zip(got, want, plain):
            assert torch.equal(g, w) and torch.equal(w, p)
    assert ep.graph_module.code.count("while_loop") >= 1


def test_a_captured_step_may_not_close_over_a_tensor():
    """The graph key of a step: its code and constants; a tensor it closes
    over would be baked into the graph, so it is refused."""
    t = torch.ones(3)
    key = control._const_key
    assert key(functools.partial(pnp._lm_body, damping=1e-3)) \
        != key(functools.partial(pnp._lm_body, damping=5.0))
    assert key(functools.partial(pnp._lm_body, damping=1e-3)) \
        == key(functools.partial(pnp._lm_body, damping=1e-3))
    with pytest.raises(ValueError, match="closes over a tensor"):
        key(lambda active, x: (active, x + t))
