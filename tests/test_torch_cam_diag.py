"""Kernel B8 (``ops/ba_matvec.cam_diag``: the block-Jacobi preconditioner's
diagonal blocks of the reduced camera system, summed over the camera-major
view) and the reduced right-hand side through B6, against the slot-wide
products and view sums the PCG path ran before them. The plain versions on
the CPU; the ``cuda`` test runs the kernel on the card (``python -m pytest
--noconftest -p no:cacheprovider -q tests/test_torch_cam_diag.py -m
cuda``). Imports nothing of the JAX package."""

import itertools

import numpy as np
import pytest
import torch

from structure_from_motion_tpu_torch.config import BAConfig
from structure_from_motion_tpu_torch.models import global_ba
from structure_from_motion_tpu_torch.ops import ba as ba_ops
from structure_from_motion_tpu_torch.ops import ba_matvec
from structure_from_motion_tpu_torch.ops.linalg import inv3x3


def _problem(seed: int, V: int = 9, M: int = 120, dtype=torch.float64):
    """A random stream: each point seen by 1 to 6 distinct cameras (camera
    weights skewed, so camera counts differ), 10% of the observations
    invalid, the last camera never observed."""
    rng = np.random.default_rng(seed)
    L = rng.integers(1, 7, M)
    weight = rng.lognormal(0.0, 1.0, V - 1)
    cam = np.concatenate([rng.choice(V - 1, n, replace=False, p=weight / weight.sum())
                          for n in L]).astype(np.int32)
    point = np.repeat(np.arange(M), L).astype(np.int32)
    O = cam.shape[0]
    order = rng.permutation(O)
    obs = ba_ops.BAObservations(
        cam=torch.from_numpy(cam[order]), point=torch.from_numpy(point[order]),
        uv_norm=torch.from_numpy(rng.normal(size=(O, 2))).to(dtype),
        valid=torch.from_numpy(rng.random(O) < 0.9))
    state = ba_ops.BAState(
        C=torch.from_numpy(rng.normal(size=(V, 3))).to(dtype),
        q=torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(V, 4))),
                                        dim=-1).to(dtype),
        X=torch.from_numpy(rng.normal(size=(M, 3)) + [0.0, 0.0, 6.0]).to(dtype),
        cam_valid=torch.ones(V, dtype=torch.bool), pt_valid=torch.ones(M, dtype=torch.bool))
    return state, obs


def _laid_out(mode: str, state, obs):
    """The stream in the layout of ``mode`` with its camera-major view ->
    (obs, lay, tiers): ``rows`` one row count (CSR stream), ``tiers``
    camera tiers (the BAL solve), ``ell_tail`` the sharded solve's hybrid
    ELL with its spill tail and one row count."""
    V = state.C.shape[0]
    counts = np.bincount(obs.cam[obs.valid].numpy(), minlength=V)
    rows = -(-int(counts.max()) // 8) * 8
    if mode == "rows":
        cfg = BAConfig(obs_layout="csr", cam_rows=rows)
        return (*ba_ops._layout(state, obs, cfg), ())
    if mode == "tiers":
        tiers = global_ba.choose_tiers(np.sort(counts)[::-1], round_to=1)
        assert len(tiers) > 1
        return (*ba_ops._layout(state, obs, BAConfig(obs_layout="csr"), tiers), tiers)
    cfg = BAConfig(obs_layout="ell", ell_rows=2, ell_tail=obs.cam.shape[0], cam_rows=rows)
    return (*ba_ops._layout(state, obs, cfg), ())


def _former_view_sum(vals, obs, lay, V, tiers):
    """The per-camera sum over the camera-major view as ``ops/ba._cam_sum``
    took it: gather through the view, mask, reshape-sum (tier by tier in rank
    order, then back to camera order)."""
    m = lay.cam_mask.to(vals.dtype).reshape((-1,) + (1,) * (vals.dim() - 1))
    g = vals[lay.cam_perm.long()] * m
    if not tiers:
        return g.reshape((V, -1) + vals.shape[1:]).sum(1)
    _, _, order, _ = ba_ops.compute_cam_tiers(obs.cam, obs.valid, V, tiers)
    outs, off = [], 0
    for n, r in tiers:
        outs.append(g.narrow(0, off, n * r).reshape((n, r) + vals.shape[1:]).sum(1))
        off += n * r
    by_rank = torch.cat(outs)
    return torch.empty_like(by_rank).index_copy_(0, order, by_rank)


@pytest.mark.parametrize("mode", ["rows", "tiers", "ell_tail"])
@pytest.mark.parametrize("nc", [7, 10])
def test_cam_diag_reference_matches_the_former_products(mode, nc):
    """B8's plain version against the slot-wide products ``W D^-1`` and
    ``(W D^-1) W^T`` over every slot, the point's ``D^-1`` broadcast to its
    slots and the former view sum (float64, to 1e-12 of each block's
    largest entry); the never-observed camera's block is zero, and every
    valid observation sits in the view."""
    state, obs = _problem(nc + len(mode))
    V, M = state.C.shape[0], state.X.shape[0]
    obs, lay, tiers = _laid_out(mode, state, obs)
    assert int(lay.cam_mask.sum()) == int(obs.valid.sum())
    assert bool((~lay.cam_mask).any())  # the view has empty slots
    rng = np.random.default_rng(nc)
    O = obs.cam.shape[0]
    W = torch.from_numpy(rng.normal(size=(O, nc, 3)))
    A = rng.normal(size=(M, 3, 3))
    Dinv = torch.from_numpy(A @ A.transpose(0, 2, 1) + np.eye(3))
    WD = torch.einsum("oic,ocd->oid", W, ba_ops._point_gather(Dinv, lay))
    want = _former_view_sum(torch.einsum("oid,ojd->oij", WD, W), obs, lay, V, tiers)
    got = ba_matvec.cam_diag_reference(W.reshape(O, 3 * nc), Dinv, obs.point, lay.cam_perm,
                                       lay.cam_mask, V, lay.cam_seg)
    assert got.shape == (V, nc, nc)
    scale = want.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-300)
    assert float(((got - want).abs() / scale).max()) <= 1e-12
    assert float(got[V - 1].abs().max()) == 0.0
    # through the operator, as the solve calls it
    assert torch.equal(ba_matvec.cam_diag(W.reshape(O, 3 * nc), Dinv, obs.point, lay.cam_perm,
                                          lay.cam_mask, V, lay.cam_seg), got)


@pytest.mark.parametrize("mode", ["rows", "tiers"])
def test_reduced_rhs_through_b6_matches_the_former_sum(mode, monkeypatch):
    """``_reduce_and_solve``'s reduced right-hand side on a camera view,
    now B6 over it (``reduce_cam``'s plain version), against the former
    slot-wide product ``W y`` and view sum, float32, to 1e-6 of its
    largest entry; the PCG itself is stubbed out to catch it."""
    state, obs = _problem(5, V=12, M=300, dtype=torch.float32)
    V = state.C.shape[0]
    obs, lay, tiers = _laid_out(mode, state, obs)
    config = BAConfig(pcg_fallback_cameras=8)
    U, D, W, b_c, b_p, _ = ba_ops._assemble(state, obs, config, lay)
    lam = torch.tensor(1e-2)
    seen = {}

    def catch(U, Dinv, W, b_red, *args, **kwargs):
        seen["b_red"] = b_red
        return torch.zeros_like(b_red)

    monkeypatch.setattr(ba_ops, "_solve_pcg", catch)
    ba_ops._reduce_and_solve(U, D, W, b_c, b_p, state, obs, config, lam, lay, None)
    Dinv = inv3x3(ba_ops._damp(D, lam, False))
    y = torch.einsum("mcd,md->mc", Dinv, b_p)
    contrib = torch.einsum("oic,oc->oi", W, ba_ops._point_gather(y, lay))
    want = b_c - _former_view_sum(contrib, obs, lay, V, tiers)
    got = seen["b_red"]
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_pcg_path_sums_its_blocks_in_b8(monkeypatch):
    """One LM iteration of the PCG path calls ``cam_diag`` once and sums
    the right-hand side and every matvec's coupling in ``reduce_cam``; the
    one-hot camera sum is never reached."""
    state, obs = _problem(9, V=12, M=300, dtype=torch.float32)
    calls = {"cam_diag": 0, "reduce_cam": 0}
    for name in calls:
        fn = getattr(ba_ops, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(ba_ops, name, counted)

    def refuse(*args, **kwargs):
        raise AssertionError("the PCG path reached the one-hot camera sum")

    monkeypatch.setattr(ba_ops, "_cam_sum", refuse)
    cg: list = []
    config = BAConfig(iterations=1, pcg_fallback_cameras=8, pcg_iterations=10)
    ba_ops.run_bundle_adjustment(state, obs, config, cg_iters=cg)
    assert calls["cam_diag"] == 1 and len(cg) == 1
    assert calls["reduce_cam"] >= 1 + cg[0]


@pytest.mark.cuda
def test_cam_diag_kernel_matches_its_plain_version_on_the_card():
    """On the card: B8 at widths 7 and 10, over one row count and over
    camera tiers, each camera's run read by one block and by several
    (``DIAG_PART_SLOTS``), against its plain version in float64 on the same
    inputs (1e-5 of each block's largest entry: float32 sums in another
    order), the same bits on a second launch; in a solve of the PCG path it
    launches once an LM iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card)")
    parts = set()
    for mode, nc, M in itertools.product(("rows", "tiers"), (7, 10), (1500, 20000)):
        state, obs = _problem(nc, V=40, M=M, dtype=torch.float32)
        obs, lay, _ = _laid_out(mode, state, obs)
        O, V, S = obs.cam.shape[0], state.C.shape[0], lay.cam_perm.shape[0]
        parts.add(-(-S // (V * ba_matvec.DIAG_PART_SLOTS)) > 1)
        g = torch.Generator().manual_seed(nc)
        w = torch.randn((O, 3 * nc), generator=g)
        A = torch.randn((M, 3, 3), generator=g)
        dinv = A @ A.transpose(1, 2) + torch.eye(3)
        args = [t.cuda() if torch.is_tensor(t) else t
                for t in (w, dinv, obs.point, lay.cam_perm, lay.cam_mask, V, lay.cam_seg)]
        got = ba_matvec.cam_diag(*args)
        assert torch.equal(got, ba_matvec.cam_diag(*args))
        want = ba_matvec.cam_diag_reference(args[0].double(), args[1].double(), *args[2:]).cpu()
        scale = want.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
        assert float(((got.cpu().double() - want).abs() / scale).max()) <= 1e-5, (mode, nc, M)
    assert parts == {False, True}
    state, obs = _problem(3, V=12, M=2000, dtype=torch.float32)
    state = ba_ops.BAState(*(t.cuda() for t in state))
    obs = ba_ops.BAObservations(*(t.cuda() for t in obs))
    config = BAConfig(iterations=3, pcg_fallback_cameras=8)
    before = ba_matvec.cam_diag.launches
    cg: list = []
    ba_ops.run_bundle_adjustment(state, obs, config, cg_iters=cg)
    assert ba_matvec.cam_diag.launches - before == 3 == len(cg)
