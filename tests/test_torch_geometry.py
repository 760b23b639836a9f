"""The port's geometry primitives and solvers against the JAX package, on
the same float32 inputs made with numpy. RANSAC runs on the JAX package's
own hypothesis index sets (drawn with the key its function uses), since
``jax.random`` draws cannot be reproduced in torch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.config import LMConfig, RansacConfig
from structure_from_motion_tpu.ops import campose as Jc
from structure_from_motion_tpu.ops import epipolar as Je
from structure_from_motion_tpu.ops import linalg as Jl
from structure_from_motion_tpu.ops import pnp as Jp
from structure_from_motion_tpu.ops import triangulation as Jt
from structure_from_motion_tpu.ops.ransac import sample_index_sets
from structure_from_motion_tpu.utils import geometry as Jg
from structure_from_motion_tpu.utils import rotations as Jr
from structure_from_motion_tpu_torch.ops import campose as Tc
from structure_from_motion_tpu_torch.ops import epipolar as Te
from structure_from_motion_tpu_torch.ops import linalg as Tl
from structure_from_motion_tpu_torch.ops import pnp as Tp
from structure_from_motion_tpu_torch.ops import triangulation as Tt
from structure_from_motion_tpu_torch.utils import geometry as Tg
from structure_from_motion_tpu_torch.utils import rotations as Tr
from tests.test_torch_config import port_config

f32 = np.float32
K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], f32)


def _cmp(jfn, tfn, args, atol):
    want = jfn(*(jnp.asarray(a) for a in args))
    got = tfn(*(torch.as_tensor(np.array(a)) for a in args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=atol)


def _rand_rot(rng, n):
    q = rng.normal(size=(n, 4)).astype(f32)
    return np.asarray(Jr.quat_to_rotation(jnp.asarray(q)), f32)


def _two_views(rng, n=300, noise=0.5, outliers=0.2):
    """Correspondences of a random scene seen from two cameras (camera 0 at
    the origin) with pixel noise; outliers are pushed 12-60 px off their
    epipolar line, so no point sits near a RANSAC threshold."""
    X = rng.uniform([-4, -3, 8], [4, 3, 16], size=(n, 3))
    R1 = np.asarray(Jr.so3_exp(jnp.asarray([0.02, -0.15, 0.03])), np.float64)
    C1 = np.array([1.5, 0.1, 0.2])

    def proj(R, C):
        x = (X - C) @ R
        return (x[:, :2] / x[:, 2:]) * 500.0 + [320.0, 240.0]

    uv0 = proj(np.eye(3), np.zeros(3))
    uv1 = proj(R1, C1)
    # exact F (ref -> que) from the relative pose: E = [t]x R_w2c
    t = -R1.T @ C1
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Ki = np.linalg.inv(K.astype(np.float64))
    F = Ki.T @ tx @ R1.T @ Ki
    lines = np.concatenate([uv0, np.ones((n, 1))], 1) @ F.T
    normal = lines[:, :2] / np.linalg.norm(lines[:, :2], axis=1, keepdims=True)
    bad = rng.random(n) < outliers
    shift = rng.uniform(12, 60, n) * rng.choice([-1.0, 1.0], n)
    uv1 = uv1 + np.where(bad[:, None], shift[:, None] * normal, 0.0)
    uv0 = uv0 + noise * rng.normal(size=(n, 2))
    uv1 = uv1 + noise * rng.normal(size=(n, 2))
    mask = rng.random(n) < 0.95
    return X.astype(f32), uv0.astype(f32), uv1.astype(f32), mask, R1.astype(f32), C1.astype(f32)


_ROT = [
    ("quat_to_rotation", lambda r: (r.normal(size=(16, 4)).astype(f32),)),
    ("rotation_to_quat", lambda r: (_rand_rot(r, 16),)),
    ("so3_exp", lambda r: (r.normal(size=(16, 3)).astype(f32),)),
    ("so3_hat", lambda r: (r.normal(size=(16, 3)).astype(f32),)),
    ("drotation_dquat", lambda r: (r.normal(size=(16, 4)).astype(f32),)),
    ("quat_normalize", lambda r: (r.normal(size=(16, 4)).astype(f32),)),
]


@pytest.mark.parametrize("name,make", _ROT, ids=[n for n, _ in _ROT])
def test_rotations_match_jax(name, make):
    _cmp(getattr(Jr, name), getattr(Tr, name), make(np.random.default_rng(0)), 1e-5)


_GEO = [
    ("camera_projection", lambda r: (np.broadcast_to(K, (8, 3, 3)).copy(), _rand_rot(r, 8),
                                     r.normal(size=(8, 3)).astype(f32))),
    ("normalized_camera_coords", lambda r: (K, r.uniform(0, 640, (50, 2)).astype(f32))),
    ("normalized_camera_coords_per_obs", lambda r: (np.broadcast_to(K, (50, 3, 3)).copy(),
                                                    r.uniform(0, 640, (50, 2)).astype(f32))),
    ("project_points", lambda r: (r.normal(size=(3, 4)).astype(f32),
                                  r.normal(size=(50, 3)).astype(f32))),
    ("to_homogeneous", lambda r: (r.normal(size=(50, 2)).astype(f32),)),
    ("from_homogeneous", lambda r: (r.normal(size=(50, 3)).astype(f32),)),
]


@pytest.mark.parametrize("name,make", _GEO, ids=[n for n, _ in _GEO])
def test_geometry_matches_jax(name, make):
    _cmp(getattr(Jg, name), getattr(Tg, name), make(np.random.default_rng(1)), 1e-5)


def _null_systems(rng, n, rows, cols):
    """Rank-deficient (rows, cols) systems with a known unit null vector."""
    A = rng.normal(size=(n, rows, cols))
    v = rng.normal(size=(n, cols))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    A -= np.einsum("nrc,nc->nr", A, v)[..., None] * v[:, None, :]
    return A.astype(f32)


def _spd(rng, n, k):
    B = rng.normal(size=(n, k, k))
    return (B @ B.transpose(0, 2, 1) + k * np.eye(k)).astype(f32)


_LIN = [
    ("inv3x3", lambda r: (_spd(r, 16, 3),), 1e-5),
    ("det3x3", lambda r: (r.normal(size=(16, 3, 3)).astype(f32),), 1e-5),
    ("solve_psd", lambda r: (_spd(r, 4, 14), r.normal(size=(4, 14)).astype(f32)), 1e-5),
]


@pytest.mark.parametrize("name,make,tol", _LIN, ids=[n for n, _, _ in _LIN])
def test_linalg_matches_jax(name, make, tol):
    _cmp(getattr(Jl, name), getattr(Tl, name), make(np.random.default_rng(2)), tol)


def test_nullspace_matches_jax_up_to_sign():
    A = _null_systems(np.random.default_rng(3), 8, 8, 9)
    want = np.asarray(Jl.nullspace(jnp.asarray(A)))
    got = Tl.nullspace(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(np.abs((want * got).sum(1)), 1.0, atol=1e-5)


def _unit_sign(F):
    F = F / np.linalg.norm(F)
    return F * np.sign(F.reshape(-1)[np.argmax(np.abs(F))])


def test_find_fundamental_on_jax_index_sets():
    """Same hypotheses -> the same inlier mask and F up to scale (1e-4)."""
    rng = np.random.default_rng(4)
    _, uv0, uv1, mask, _, _ = _two_views(rng)
    cfg = RansacConfig(inlier_threshold=2.0, iteration=200)
    key = jax.random.key(0)
    want = Je.find_fundamental(key, jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(mask), cfg)
    idx = np.asarray(sample_index_sets(key, jnp.asarray(mask), cfg.num_hypotheses, 8))
    got = Te.find_fundamental(torch.as_tensor(idx), *(torch.as_tensor(a) for a in (uv0, uv1, mask)),
                              port_config(cfg))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 150
    np.testing.assert_allclose(_unit_sign(got.F.numpy()), _unit_sign(np.asarray(want.F)), atol=1e-4)


def test_find_fundamental_batched_and_exact8():
    """A leading view axis gives the per-view results; a view with exactly
    8 valid points takes the direct 8-point solution."""
    rng = np.random.default_rng(5)
    _, uv0, uv1, mask, _, _ = _two_views(rng, n=120, outliers=0.0)
    m8 = np.zeros_like(mask)
    m8[np.where(mask)[0][:8]] = True
    masks = np.stack([mask, m8])
    cfg = RansacConfig(inlier_threshold=2.0, iteration=64)
    idx = torch.as_tensor(np.stack([np.asarray(sample_index_sets(
        jax.random.key(v), jnp.asarray(m), cfg.num_hypotheses, 8)) for v, m in enumerate(masks)]))
    b = lambda a: torch.as_tensor(np.stack([a, a]))  # noqa: E731
    both = Te.find_fundamental(idx, b(uv0), b(uv1), torch.as_tensor(masks), port_config(cfg))
    for v in range(2):
        one = Te.find_fundamental(idx[v], torch.as_tensor(uv0), torch.as_tensor(uv1),
                                  torch.as_tensor(masks[v]), port_config(cfg))
        assert torch.equal(both.inliers[v], one.inliers)
        np.testing.assert_allclose(both.F[v].numpy(), one.F.numpy(), atol=1e-5, rtol=1e-5)
    assert torch.equal(both.inliers[1], torch.as_tensor(m8))
    want = Je.find_fundamental(jax.random.key(0), jnp.asarray(uv0), jnp.asarray(uv1),
                               jnp.asarray(m8), cfg)
    np.testing.assert_allclose(_unit_sign(both.F[1].numpy()), _unit_sign(np.asarray(want.F)),
                               atol=1e-4)


def test_epipolar_helpers_match_jax():
    rng = np.random.default_rng(6)
    _, uv0, uv1, mask, _, _ = _two_views(rng, outliers=0.0)
    _cmp(Je.hartley_normalization, Te.hartley_normalization, (uv0, mask), 1e-5)
    h0 = np.concatenate([uv0, np.ones_like(uv0[:, :1])], 1)
    h1 = np.concatenate([uv1, np.ones_like(uv1[:, :1])], 1)
    F = rng.normal(size=(5, 3, 3)).astype(f32)
    _cmp(Je.sampson_distances, Te.sampson_distances, (F, h0, h1), 1e-4)
    Fj = np.asarray(Je.eight_point(jnp.asarray(h0[:40] / 300), jnp.asarray(h1[:40] / 300)))
    Ft = Te.eight_point(torch.as_tensor(h0[:40] / 300), torch.as_tensor(h1[:40] / 300)).numpy()
    np.testing.assert_allclose(_unit_sign(Ft), _unit_sign(Fj), atol=1e-4)
    Ej = np.asarray(Je.essential_from_fundamental(jnp.asarray(Fj), jnp.asarray(K), jnp.asarray(K)))
    Et = Te.essential_from_fundamental(torch.as_tensor(Fj), torch.as_tensor(K),
                                       torch.as_tensor(K)).numpy()
    np.testing.assert_allclose(_unit_sign(Et), _unit_sign(Ej), atol=1e-4)


@pytest.mark.parametrize("score_subset", [0, 128])
def test_linear_pnp_ransac_on_jax_index_sets(score_subset):
    """Same hypothesis (and scoring-subset) draws -> the same inliers and
    pose; with score_subset the JAX function splits its key into the
    subset draw and the hypothesis draw."""
    rng = np.random.default_rng(7)
    X, _, uv1, mask, R1, C1 = _two_views(rng, n=400, outliers=0.3)
    cfg = RansacConfig(inlier_threshold=8.0, sample_num=6, iteration=256,
                       score_subset=score_subset)
    key = jax.random.key(3)
    want = Jp.linear_pnp_ransac(key, *(jnp.asarray(a) for a in (X, uv1, K, mask)), cfg)
    sub = None
    if score_subset:
        k_sub, k_draw = jax.random.split(key)
        u = jnp.where(jnp.asarray(mask), jax.random.uniform(k_sub, (400,)), -jnp.inf)
        sub = torch.as_tensor(np.asarray(jax.lax.top_k(u, score_subset)[1]))
    else:
        k_draw = key
    idx = np.asarray(sample_index_sets(k_draw, jnp.asarray(mask), cfg.num_hypotheses, 6))
    got = Tp.linear_pnp_ransac(torch.as_tensor(idx),
                               *(torch.as_tensor(a) for a in (X, uv1, K, mask)),
                               port_config(cfg), sub=sub)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.C.numpy(), np.asarray(want.C), atol=1e-3)
    np.testing.assert_allclose(got.C.numpy(), C1, atol=0.05)


def test_refine_pnp_matches_jax():
    rng = np.random.default_rng(8)
    X, _, uv1, mask, R1, C1 = _two_views(rng, outliers=0.0)
    R0 = np.asarray(Jr.so3_exp(jnp.asarray([0.01, 0.02, -0.01]))) @ R1
    args = (X, uv1, K, mask, R0.astype(f32), (C1 + 0.1).astype(f32))
    cfg = LMConfig(damping=5.0, iterations=100)
    want = Jp.refine_pnp(*(jnp.asarray(a) for a in args), cfg)
    got = Tp.refine_pnp(*(torch.as_tensor(a) for a in args), port_config(cfg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_solve_pnp_dlt_recovers_pose():
    """The SVD DLT (the one path, on the CPU and the card) recovers a
    noise-free pose."""
    rng = np.random.default_rng(9)
    X, _, uv1, _, R1, C1 = _two_views(rng, noise=0.0, outliers=0.0)
    meas = Tg.normalized_camera_coords(torch.as_tensor(K), torch.as_tensor(uv1))
    R, C = Tp.solve_pnp_dlt(torch.as_tensor(X), meas)
    np.testing.assert_allclose(R.numpy(), R1, atol=1e-3)
    np.testing.assert_allclose(C.numpy(), C1, atol=1e-2)


@pytest.mark.parametrize("case", ["minimal", "weighted"])
def test_solve_pnp_dlt_matches_jax(case):
    """Batched 6-point samples (noise-free) and a weighted all-point refit
    (0.5 px noise) give JAX's CPU poses: R to 1e-4, C to 1e-3 (the centre
    sits 1.5 units away and is recovered from t / s_max)."""
    rng = np.random.default_rng(12)
    noise = 0.0 if case == "minimal" else 0.5
    X, _, uv1, mask, _, _ = _two_views(rng, n=240, noise=noise, outliers=0.0)
    meas = np.asarray(Jg.normalized_camera_coords(jnp.asarray(K), jnp.asarray(uv1)))
    if case == "minimal":
        idx = np.stack([rng.permutation(240)[:6] for _ in range(32)])
        args, kw = (X[idx], meas[idx]), {}
    else:
        args, kw = (X, meas), {"weights": mask.astype(f32)}
    jfn = jax.vmap(Jp.solve_pnp_dlt) if case == "minimal" else Jp.solve_pnp_dlt
    want = jfn(*(jnp.asarray(a) for a in args), **{k: jnp.asarray(v) for k, v in kw.items()})
    got = Tp.solve_pnp_dlt(*(torch.as_tensor(a) for a in args),
                           **{k: torch.as_tensor(v) for k, v in kw.items()})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-3)


def test_minimal_pnp_poses_under_noise(monkeypatch):
    """6-point samples with 0.5 px noise: the port's SVD poses sit within
    1 unit of the true centre at the median (the centre is 1.5 units from
    the origin, the points 8-16 away), at least 5x closer than the JAX
    package's accelerator path (gram null vector + Newton polar factor,
    forced here), which is why the port keeps the SVD on the card too."""
    rng = np.random.default_rng(13)
    X, _, uv1, _, _, C1 = _two_views(rng, n=240, noise=0.5, outliers=0.0)
    meas = np.asarray(Jg.normalized_camera_coords(jnp.asarray(K), jnp.asarray(uv1)))
    idx = np.stack([rng.permutation(240)[:6] for _ in range(256)])
    _, C = Tp.solve_pnp_dlt(torch.as_tensor(X[idx]), torch.as_tensor(meas[idx]))
    err = np.linalg.norm(C.numpy() - C1, axis=1)
    monkeypatch.setattr(Jp, "use_fast_nullspace", lambda: True)
    _, Cj = jax.vmap(Jp.solve_pnp_dlt)(jnp.asarray(X[idx]), jnp.asarray(meas[idx]))
    err_gram = np.linalg.norm(np.asarray(Cj) - C1, axis=1)
    assert np.isfinite(err).all()
    assert np.median(err) < 1.0
    assert np.median(err) * 5 < np.median(err_gram)


def _pair(rng):
    X, uv0, uv1, mask, R1, C1 = _two_views(rng, outliers=0.0)
    P0 = np.asarray(Jg.camera_projection(jnp.asarray(K), jnp.eye(3, dtype=jnp.float32),
                                         jnp.zeros(3, jnp.float32)))
    P1 = np.asarray(Jg.camera_projection(jnp.asarray(K), jnp.asarray(R1), jnp.asarray(C1)))
    P = np.stack([P0, P1]).astype(f32)
    uv = np.stack([uv0, uv1], 1)
    return P, uv, np.stack([mask, mask], 1), X


def test_triangulation_matches_jax():
    """Linear DLT, LM refinement and residuals to 1e-4 (relative for the
    points, which sit 8-16 units away), on the observed points (a point
    with no observation has an arbitrary null vector)."""
    P, uv, om, _ = _pair(np.random.default_rng(10))
    ok = om[:, 0]
    J = lambda *a: [jnp.asarray(x) for x in a]  # noqa: E731
    Tn = lambda *a: [torch.as_tensor(x) for x in a]  # noqa: E731
    X0 = np.asarray(Jt.linear_triangulate(*J(P, uv, om)))
    np.testing.assert_allclose(Tt.linear_triangulate(*Tn(P, uv, om)).numpy()[ok], X0[ok],
                               atol=1e-4, rtol=1e-4)
    cfg = LMConfig(damping=5.0, iterations=50)
    want = np.asarray(Jt.refine_triangulate(*J(P, uv, om, X0), cfg))
    got = Tt.refine_triangulate(*Tn(P, uv, om, X0), port_config(cfg)).numpy()
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-4, rtol=1e-4)
    # residuals = projection - measurement at |uv| ~ 500 px, where one f32
    # ulp is 6e-5 px: hold the projections (residual + measurement) to 1e-4
    rj, dj = Jt.reprojection_residuals(*J(P, want[:, :3], uv, om))
    rt, dt = Tt.reprojection_residuals(*Tn(P, want[:, :3], uv, om))
    np.testing.assert_allclose(rt.numpy() + uv, np.asarray(rj) + uv, rtol=1e-4)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4)
    # per-point projection pairs (the incremental engine's flat triangulation)
    Pn = np.broadcast_to(P, (uv.shape[0], 2, 3, 4)).copy()
    got = Tt.linear_triangulate(*Tn(Pn, uv, om)).numpy()
    np.testing.assert_allclose(got[ok], X0[ok], atol=1e-4, rtol=1e-4)


def test_campose_matches_jax():
    """E decomposition (as a set: SVD sign conventions may order the four
    candidates differently), the cheirality winner, and the essential-manifold
    refinement to 1e-4."""
    P, uv, om, _ = _pair(np.random.default_rng(11))
    Fj = Je.find_fundamental(jax.random.key(2), jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]),
                             jnp.asarray(om[:, 0]),
                             RansacConfig(inlier_threshold=2.0, iteration=64))
    E = np.asarray(Je.essential_from_fundamental(Fj.F, jnp.asarray(K), jnp.asarray(K)))
    cj = Jc.decompose_essential(jnp.asarray(E))
    ct = Tc.decompose_essential(torch.as_tensor(E))
    for Rt, Ct in zip(ct.R.numpy(), ct.C.numpy()):
        assert min(np.abs(Rt - np.asarray(Rj)).max() + np.abs(Ct - np.asarray(Cj)).max()
                   for Rj, Cj in zip(cj.R, cj.C)) < 1e-4

    def winner(cmod, tmod, c, arr):
        Pc = cmod.candidate_projections(arr(K), c)
        X4 = [tmod.linear_triangulate(arr(np.stack([P[0], np.asarray(Pc[i])])), arr(uv), arr(om))
              for i in range(4)]
        stack = jnp.stack if arr is jnp.asarray else torch.stack
        best, counts, _ = cmod.disambiguate_poses(arr(P[0]), Pc, stack(X4), arr(om[:, 0]))
        return np.asarray(c.R[int(best)]), np.asarray(c.C[int(best)]), int(np.asarray(counts).max())

    wj = winner(Jc, Jt, cj, jnp.asarray)
    wt = winner(Tc, Tt, ct, torch.as_tensor)
    np.testing.assert_allclose(wt[0], wj[0], atol=1e-4)
    np.testing.assert_allclose(wt[1], wj[1], atol=1e-4)
    assert wt[2] == wj[2]

    t = np.asarray(cj.t[0])
    x1 = np.asarray(Jg.normalized_camera_coords(jnp.asarray(K), jnp.asarray(uv[:, 0])))
    x2 = np.asarray(Jg.normalized_camera_coords(jnp.asarray(K), jnp.asarray(uv[:, 1])))
    args = (wj[0], t, x1, x2, om[:, 0])
    _cmp(Jc.refine_relative_pose, Tc.refine_relative_pose, args, 1e-4)
