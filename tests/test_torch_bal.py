"""The self-calibrating global solve on BAL problems (``io/bal.py``, the
10-wide camera block of ``ops/ba.py``, ``ops/reproj.py``, the plain versions
of kernels B4-B6) against the plain float64 reference ``bal_reference.py``,
at a small size on the CPU: 12 cameras, 400 points, about 2,000
observations."""

import dataclasses
import subprocess
import sys

import bal_reference as ref
import numpy as np
import pytest
import torch

from structure_from_motion_tpu_torch.config import BAConfig
from structure_from_motion_tpu_torch.io import bal
from structure_from_motion_tpu_torch.models import global_ba
from structure_from_motion_tpu_torch.ops import ba as ba_ops
from structure_from_motion_tpu_torch.ops.ba_cuda import ba_blocks_reference
from structure_from_motion_tpu_torch.ops.ba_matvec import expand_cam_reference, reduce_cam_reference
from structure_from_motion_tpu_torch.ops.reproj import batched_residual_jacobians

# BAL's squared loss; the default lambda schedule, in Marquardt's form on
# the 10-wide block (ops/ba.py)
CONFIG = BAConfig(huber_delta=0.0)
ITERATIONS = 5


def _look_at(C: np.ndarray, target: np.ndarray) -> np.ndarray:
    """BAL rotations (rows: the camera's axes; it looks down its -z)."""
    z = C - target
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return np.stack([x, np.cross(z, x), z], 1)


def _draw(seed: int, V: int = 12, M: int = 400):
    """(the "-pre" problem, the true one): cameras on a ring around a ball
    of points, each point seen by 3 to 7 cameras, 1 px noise; the start
    turned 0.5 degrees, moved 1% of the extent, f off by 2%, k1 = k2 = 0."""
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, V)
    C = np.stack([10 * np.cos(phi), 10 * np.sin(phi), rng.uniform(-1, 1, V)], 1)
    R = _look_at(C, rng.normal(0, 0.3, (V, 3)))
    w = bal.rotation_to_angle_axis(torch.from_numpy(R)).numpy()
    intr = np.stack([rng.uniform(450, 550, V), rng.normal(0, 0.05, V), rng.normal(0, 0.005, V)],
                    1)
    cams = np.concatenate([w, -(R @ C[..., None])[..., 0], intr], 1)
    X = rng.normal(0, 1.0, (M, 3))
    L = rng.integers(3, 8, M)
    point = np.repeat(np.arange(M), L)
    cam = np.concatenate([rng.choice(V, n, replace=False) for n in L])
    xy = ref.snavely_project(*(torch.from_numpy(a) for a in (cams, X, cam, point))).numpy()
    true = bal.BALProblem(cams, X, cam, point, xy + rng.normal(0, 1.0, xy.shape))
    turn = rng.normal(size=(V, 3))
    turn *= np.radians(0.5) / np.linalg.norm(turn, axis=1, keepdims=True)
    R0 = ref.rodrigues(torch.from_numpy(turn)).numpy() @ R
    C0 = C + 0.02 * rng.normal(size=(V, 3))
    pre = np.concatenate([bal.rotation_to_angle_axis(torch.from_numpy(R0)).numpy(),
                          -(R0 @ C0[..., None])[..., 0],
                          np.stack([intr[:, 0] * (1 + 0.02 * rng.choice([-1, 1], V)),
                                    np.zeros(V), np.zeros(V)], 1)], 1)
    return true._replace(cameras=pre, points=X + 0.02 * rng.normal(size=X.shape)), true


@pytest.fixture(scope="module")
def problem():
    return _draw(2 ** 31 + 5)[0]


@pytest.fixture(scope="module")
def reference(problem):
    p = ref.as_problem(*problem, "cpu")
    return ref.solve(p, ITERATIONS, dataclasses.asdict(CONFIG))


def _solve(problem, config=CONFIG):
    out, costs = global_ba.solve_global(bal.to_problem(problem, "cpu"), config,
                                        iterations=ITERATIONS)
    return out, np.asarray(costs, np.float64)


def test_bal_text_round_trip(problem, tmp_path):
    """Written at full precision, read back equal; BAL's own e-notation
    reads; a file whose counts do not add up raises."""
    path = tmp_path / "p.txt"
    bal.write_bal(path, problem)
    back = bal.read_bal(path)
    for a, b in zip(problem, back):
        np.testing.assert_array_equal(np.asarray(a), b)
    text = ("1 2 2\n0 0 -3.326500e+02 2.620900e+02\n0 1 -1.997600e+02 1.667000e+02\n"
            + "\n".join(["1.57e-02", "-1.27e-02", "-4.40e-03", "-3.41e-02", "-1.07e-01",
                         "1.12e+00", "3.99e+02", "-3.18e-07", "5.88e-13"])
            + "\n-6.12e-01\n5.71e-01\n-1.85e+00\n1.70e+00\n-5.20e-01\n-9.27e-01\n")
    (tmp_path / "q.txt").write_text(text)
    q = bal.read_bal(tmp_path / "q.txt")
    assert q.cameras.shape == (1, 9) and q.points.shape == (2, 3)
    assert q.cameras[0, 6] == 399.0 and q.xy[1, 1] == 166.7 and list(q.point) == [0, 1]
    (tmp_path / "r.txt").write_text(text + "1.0\n")
    with pytest.raises(ValueError, match="numbers where"):
        bal.read_bal(tmp_path / "r.txt")


def test_port_projection_is_snavelys_on_the_raw_parameters(problem):
    """The port's residuals of the converted problem (float32) equal BAL's
    formula on the raw parameters (float64), y negated, to float32
    rounding: positions of ~300 px carry ~2e-5 px of rounding a step of
    the projection, so 2e-3 px is two orders above it and five below the
    1 px noise; the inverse change of convention is exact to float64."""
    gp = bal.to_problem(problem, "cpu")
    (st, intr), obs, O = gp.state, gp.obs, gp.n_obs
    cam, pt = obs.cam[:O].long(), obs.point[:O].long()
    res, _, _ = batched_residual_jacobians(st.C[cam], st.q[cam], st.X[pt], obs.uv_norm[:O],
                                           intr[cam])
    want = problem.xy - ref.snavely_project(
        *(torch.from_numpy(np.asarray(a)) for a in problem[:4])).numpy()
    got = res.double().numpy() * np.array([1.0, -1.0])
    assert np.abs(got - want).max() < 2e-3
    assert np.abs(got - want).max() > 0  # float32 does round
    cams, pts = bal.from_state(bal.to_problem(problem, "cpu", dtype=torch.float64).state,
                               len(problem.points))
    np.testing.assert_allclose(cams.numpy(), problem.cameras, rtol=0, atol=1e-11)
    np.testing.assert_array_equal(pts.numpy(), problem.points)


def _ref_blocks(problem):
    """The reference's residuals and autograd Jacobians at the start, in
    the port's sign (y negated), float64."""
    p = ref.as_problem(*problem, "cpu")
    C, q, intr = ref.to_unknowns(p.cameras)
    res, Jc, Jp = ref._jacobians(C, q, intr, p.points, p, ref._Arith("f64"))
    flip = torch.tensor([1.0, -1.0], dtype=torch.float64)
    return res * flip, Jc * flip[:, None], Jp * flip[:, None]


def test_width10_blocks_match_the_reference(problem):
    """B4's plain version at the 10-wide block (float64) against the
    products of the reference's autograd Jacobians: the same numbers to
    float64 rounding (1e-9 relative: sums of ~2,000 terms)."""
    gp = bal.to_problem(problem, "cpu", dtype=torch.float64)
    (st, intr), obs, O = gp.state, gp.obs, gp.n_obs
    cam, pt = obs.cam[:O], obs.point[:O].long()
    c = cam.long()
    U, b_c, DtD, W, bp, cost = ba_blocks_reference(
        cam, st.C[c], st.q[c], st.X[pt], obs.uv_norm[:O], torch.ones(O, dtype=torch.float64),
        12, 0.0, intr[c])
    res, Jc, Jp = _ref_blocks(problem)
    V = 12
    want_U = torch.zeros(V, 10, 10, dtype=torch.float64).index_add_(
        0, c, torch.einsum("oki,okj->oij", Jc, Jc))
    want_bc = torch.zeros(V, 10, dtype=torch.float64).index_add_(
        0, c, torch.einsum("oki,ok->oi", Jc, res))
    for got, want in ((U, want_U), (b_c, want_bc), (DtD, torch.einsum("oki,okj->oij", Jp, Jp)),
                      (W, torch.einsum("oki,okj->oij", Jc, Jp)),
                      (bp, torch.einsum("oki,ok->oi", Jp, res))):
        scale = want.abs().max()
        assert float((got - want).abs().max() / scale) < 1e-9
    assert abs(float(cost) / float((res ** 2).sum()) - 1) < 1e-12


def test_width10_jacobian_against_central_differences(problem):
    """The closed-form 2x10 and 2x3 rows against central differences of the
    port's own residual (float64; step 1e-6 of each unknown's scale, so
    the truncation error ~1e-12 and the rounding ~1e-10 lie well under the
    1e-6 relative bound)."""
    gp = bal.to_problem(problem, "cpu", dtype=torch.float64)
    (st, intr), obs = gp.state, gp.obs
    idx = torch.arange(0, gp.n_obs, 97)
    c, pt = obs.cam[idx].long(), obs.point[idx].long()
    args = [st.C[c], st.q[c], st.X[pt], obs.uv_norm[idx], intr[c]]
    _, J_cam, J_pt = batched_residual_jacobians(*args)

    def proj(C, q, X, intr):
        r, _, _ = batched_residual_jacobians(C, q / q.norm(dim=-1, keepdim=True), X,
                                             obs.uv_norm[idx], intr)
        return obs.uv_norm[idx] - r

    base = dict(C=args[0], q=args[1], X=args[2], intr=args[4])
    cols = [("C", k) for k in range(3)] + [("q", k) for k in range(4)] \
        + [("intr", k) for k in range(3)]
    for j, (name, k) in enumerate(cols + [("X", k) for k in range(3)]):
        h = 1e-6 * max(1.0, float(base[name][:, k].abs().max()))
        plus, minus = dict(base), dict(base)
        plus[name] = base[name].clone()
        plus[name][:, k] += h
        minus[name] = base[name].clone()
        minus[name][:, k] -= h
        fd = (proj(**plus) - proj(**minus)) / (2 * h)
        got = J_cam[:, :, j] if j < 10 else J_pt[:, :, j - 10]
        if name == "q":  # the port differentiates q's raw form at the unit quaternion
            continue
        assert float((fd - got).abs().max()) <= 1e-6 * max(1.0, float(got.abs().max())), name
    # q: the raw quadratic form's derivative, as the reference takes it
    _, Jc, _ = _ref_blocks(problem)
    np.testing.assert_allclose(J_cam[:, :, 3:7].numpy(), Jc[idx][:, :, 3:7].numpy(),
                               rtol=1e-9, atol=1e-9 * float(Jc[:, :, 3:7].abs().max()))


def test_width10_matvec_plain_versions_and_camera_tiers():
    """B5's and B6's plain versions at the 10-wide block, B6 also over a
    camera-tiered view (``compute_cam_tiers``): each equal to the dense
    products (float64); every camera's valid observations sit in its own
    run of the view exactly once."""
    rng = np.random.default_rng(3)
    V, O = 9, 500
    cam = torch.from_numpy(np.minimum(rng.geometric(0.3, O) - 1, V - 1).astype(np.int32))
    valid = torch.from_numpy(rng.random(O) < 0.9)
    W = torch.from_numpy(rng.normal(size=(O, 10, 3)))
    x, y = torch.from_numpy(rng.normal(size=(V, 10))), torch.from_numpy(rng.normal(size=(O, 3)))
    t = expand_cam_reference(cam, W.reshape(O, 30), x)
    np.testing.assert_allclose(t.numpy(), torch.einsum("oic,oi->oc", W, x[cam.long()]).numpy(),
                               rtol=1e-12, atol=1e-12)
    counts = np.bincount(cam.numpy()[valid.numpy()], minlength=V)
    tiers = global_ba.choose_tiers(np.sort(counts)[::-1], round_to=1)
    perm, mask, order, seg = ba_ops.compute_cam_tiers(cam, valid, V, tiers)
    assert perm.shape[0] == sum(n * r for n, r in tiers) <= 2 * int(counts.sum())
    assert sorted(perm[mask].tolist()) == sorted(np.nonzero(valid.numpy())[0].tolist())
    for v in range(V):
        s, n = seg[v].tolist()
        run = perm[s:s + n][mask[s:s + n]].long()
        assert run.tolist() == sorted(run.tolist()) and bool((cam[run] == v).all())
    z = torch.einsum("oic,oc->oi", W, y) * valid[:, None].double()
    want = torch.zeros(V, 10, dtype=torch.float64).index_add_(0, cam.long(), z)
    got = reduce_cam_reference(W.reshape(O, 30), y, perm, mask, V, seg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    assert order.tolist() == np.argsort(-counts, kind="stable").tolist()


@pytest.mark.parametrize("path", ["dense", "pcg"])
def test_solve_costs_match_the_reference(problem, reference, path):
    """Five LM iterations through ``solve_global`` (float32: the card's
    working type) against the float64 reference on the same arrays: every
    cost within 1e-5 relative (sound reads ~1e-6: float32 residuals and a
    PCG stopped at rtol 1e-6), the refined intrinsics within 1e-2 of f
    and 1e-4 of k1, k2. ``pcg``: the reduced system by block-Jacobi PCG
    (kernels B5/B6's plain versions), ``pcg_fallback_cameras`` lowered."""
    config = CONFIG if path == "dense" else dataclasses.replace(CONFIG, pcg_fallback_cameras=8)
    out, costs = _solve(problem, config)
    gap = np.abs(costs - reference["costs"]) / reference["costs"]
    assert gap.max() < 1e-5, gap
    assert reference["costs"][-1] < 0.2 * reference["costs"][0]
    d = np.abs(out.intr.double().numpy() - reference["intr"]).max(0)
    assert d[0] < 1e-2 and d[1] < 1e-4 and d[2] < 1e-4, d
    cams, _ = bal.from_state(out, len(problem.points))
    assert np.abs(cams.numpy()[:, 6:] - reference["cameras"][:, 6:]).max() < 1e-2


def test_frozen_intrinsics_fail_the_cost_comparison(problem, reference, monkeypatch):
    """The step's intrinsics columns zeroed, and nothing else: the costs
    part from the reference's by over ten times the bound above."""
    solve = ba_ops._reduce_and_solve

    def frozen(*args, **kwargs):
        dc, dp = solve(*args, **kwargs)
        return torch.cat([dc[..., :7], torch.zeros_like(dc[..., 7:])], -1), dp

    monkeypatch.setattr(ba_ops, "_reduce_and_solve", frozen)
    _, costs = _solve(problem)
    gap = np.abs(costs - reference["costs"]) / reference["costs"]
    assert gap.max() > 1e-4, gap


def test_bundle_subcommand_writes_a_readable_bal_file(problem, tmp_path):
    """``python -m structure_from_motion_tpu_torch bundle`` on the CPU: the
    refined file reads back with the problem's counts and observations,
    and costs less than the start."""
    src, dst = tmp_path / "pre.txt", tmp_path / "refined.txt"
    bal.write_bal(src, problem)
    out = subprocess.run([sys.executable, "-m", "structure_from_motion_tpu_torch", "bundle",
                          "--problem", str(src), "--out", str(dst), "--iterations", "3",
                          "--device", "cpu"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = bal.read_bal(dst)
    assert got.cameras.shape == problem.cameras.shape and got.points.shape == problem.points.shape
    np.testing.assert_array_equal(got.xy, problem.xy)
    before = ref.bal_cost(ref.as_problem(*problem, "cpu"))
    assert ref.bal_cost(ref.as_problem(*got, "cpu")) < 0.5 * before


@pytest.mark.cuda
def test_width10_kernels_match_their_plain_versions_on_the_card(problem):
    """On the card (``python -m pytest --noconftest -p no:cacheprovider -q
    tests/test_torch_bal.py -m cuda``): B4, B5 and B6 at the 10-wide block
    against their plain versions on the same CUDA inputs (1e-5 of each
    output's largest entry: float32 sums in another order), B4's and B6's
    bits equal on a second launch, B6 over camera tiers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card)")
    from structure_from_motion_tpu_torch.ops import ba_cuda, ba_matvec

    gp = bal.to_problem(problem, "cuda")
    (st, intr), obs, O = gp.state, gp.obs, gp.n_obs
    c = obs.cam[:O].long()
    args = (obs.cam[:O].contiguous(), st.C[c].contiguous(), st.q[c].contiguous(),
            st.X[obs.point[:O].long()].contiguous(), obs.uv_norm[:O].contiguous(),
            torch.ones(O, device="cuda"), 12, 0.0, intr[c].contiguous())
    got, again = ba_cuda.ba_blocks(*args), ba_cuda.ba_blocks(*args)
    for g, a, w in zip(got, again, ba_cuda.ba_blocks_reference(*args)):
        assert torch.equal(g, a)
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    W = got[3].reshape(O, 30)
    x = torch.randn(12, 10, device="cuda")
    want = ba_matvec.expand_cam_reference(obs.cam[:O], W, x)
    assert float((ba_matvec.expand_cam(obs.cam[:O].contiguous(), W, x) - want).abs().max()) \
        <= 1e-5 * float(want.abs().max())
    valid = torch.ones(O, dtype=torch.bool, device="cuda")
    counts = np.bincount(c.cpu().numpy(), minlength=12)
    tiers = global_ba.choose_tiers(np.sort(counts)[::-1], round_to=1)
    perm, mask, _, seg = ba_ops.compute_cam_tiers(obs.cam[:O], valid, 12, tiers)
    y = torch.randn(O, 3, device="cuda")
    coup = ba_matvec.reduce_cam(W, y, perm, mask, 12, seg)
    want = ba_matvec.reduce_cam_reference(W, y, perm, mask, 12, seg)
    assert torch.equal(coup, ba_matvec.reduce_cam(W, y, perm, mask, 12, seg))
    assert float((coup - want).abs().max()) <= 1e-5 * float(want.abs().max())
