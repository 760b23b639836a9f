"""Kernel B7 (``ops/small_svd.py``): the plain SVD and null vector of the
port at every shape of the frame path against the JAX package's
``ops/linalg.nullspace`` and numpy, degenerate samples included, under the
documented sign rule; the ``sfm::small_svd`` operator (vmap rule, fake
shapes); and, on the card only, the kernel against the plain version."""

import numpy as np
import pytest
import torch

from structure_from_motion_tpu_torch.ops import small_svd as S
from structure_from_motion_tpu_torch.ops.linalg import nullspace
from structure_from_motion_tpu_torch.tools.svd_cases import cases

f32 = np.float32


def _sign_np(v):
    """The sign rule on numpy rows: the largest component (first among
    equals in magnitude) positive."""
    big = np.abs(v).argmax(-1)[..., None]
    return v * np.where(np.take_along_axis(v, big, -1) < 0, -1.0, 1.0)


CASES = cases()


@pytest.fixture(scope="module")
def jax_linalg():
    import jax  # noqa: F401  (the JAX package's reference, on the CPU)
    from structure_from_motion_tpu.ops import linalg

    return linalg


def _unit_null_ok(A, v, want_res, atol):
    """``v`` finite and unit, with ``|A v|`` within ``atol`` of the
    reference's (a degenerate matrix has a null space of more than one
    direction: any unit vector in it is a null vector)."""
    assert np.isfinite(v).all()
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    res = np.linalg.norm(np.einsum("...mn,...n->...m", A.astype(np.float64), v), axis=-1)
    assert (res <= want_res + atol).all()


@pytest.mark.parametrize("case", list(CASES))
def test_nullspace_matches_jax_and_numpy(case, jax_linalg):
    """The port's null vector on the CPU (the plain version, the SVD under
    the sign rule) against numpy's SVD in float64 and the JAX package's
    ``nullspace``, both under the same rule: equal to 1e-4 where the two
    smallest singular values are apart (1e-3 of the largest), else a unit
    null vector just as small in ``|A v|``."""
    A = CASES[case]
    got = nullspace(torch.as_tensor(A)).numpy()
    full = A.shape[-2] < A.shape[-1]
    u, s, vh = np.linalg.svd(A.astype(np.float64), full_matrices=full)
    want = _sign_np(vh[..., -1, :])
    jv = _sign_np(np.asarray(jax_linalg.nullspace(A), np.float64))
    s_full = np.concatenate([s, np.zeros(s.shape[:-1] + (A.shape[-1] - s.shape[-1],))], -1)
    gap = (s_full[..., -2] - s_full[..., -1]) > 1e-3 * np.maximum(s_full[..., 0], 1e-30)
    want_res = np.linalg.norm(np.einsum("...mn,...n->...m", A.astype(np.float64), want), axis=-1)
    _unit_null_ok(A, got, want_res, 1e-4 * np.maximum(s_full[..., 0], 1e-30))
    np.testing.assert_allclose(got[gap], want[gap], atol=1e-4)
    np.testing.assert_allclose(jv[gap], want[gap], atol=1e-4)


def test_svd3_matches_numpy():
    """The 3 x 3 factors under the sign rule against numpy's: singular
    values to 1e-5 relative, vectors to 1e-4, and U S Vh rebuilding A."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(512, 3, 3)).astype(f32)
    A[:8, :, 2] = A[:8, :, 1]  # rank 2, as an exact F would be
    U, Sv, Vh = (t.numpy() for t in S.svd3(torch.as_tensor(A)))
    u, s, vh = np.linalg.svd(A.astype(np.float64))
    vh_w, u_w = S.sign_rule(torch.as_tensor(vh), torch.as_tensor(u))
    np.testing.assert_allclose(Sv, s, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Vh[8:], vh_w.numpy()[8:], atol=1e-4)
    np.testing.assert_allclose(U[8:], u_w.numpy()[8:], atol=1e-4)
    np.testing.assert_allclose(np.einsum("bij,bj,bjk->bik", U, Sv, Vh), A, atol=1e-5)
    big = np.abs(Vh).argmax(-1)
    assert (np.take_along_axis(Vh, big[..., None], -1) > 0).all()


def test_sign_rule_keeps_the_products_bits():
    """Flipping a pair (u_i, v_i) is exact: the rank-2 projection and the
    polar factor the frame path takes keep every bit."""
    rng = np.random.default_rng(2)
    A = torch.as_tensor(rng.normal(size=(256, 3, 3)).astype(f32))
    u, s, vh = torch.linalg.svd(A)
    vs, us = S.sign_rule(vh, u)
    s2 = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    assert torch.equal((u * s2[..., None, :]) @ vh, (us * s2[..., None, :]) @ vs)
    assert torch.equal(u @ vh, us @ vs)


def test_operator_vmap_and_fake_shapes():
    """``torch.func.vmap`` over ``sfm::small_svd`` (the batched engine's
    ``lane_map``) equals the call on the whole batch, bit for bit, and the
    fake implementation gives the real outputs' shapes."""
    A = torch.as_tensor(CASES["4x4 triangulation"][:24].reshape(3, 8, 4, 4))
    got = torch.func.vmap(nullspace)(A)
    assert torch.equal(got, nullspace(A))
    got3 = torch.func.vmap(S.svd3)(A[..., :3, :3])
    for g, w in zip(got3, S.svd3(A[..., :3, :3])):
        assert torch.equal(g, w)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        for null_only, shape in ((True, (5, 8, 9)), (False, (5, 3, 3))):
            fake = torch.ops.sfm.small_svd(mode.from_tensor(torch.zeros(shape)), null_only)
            real = S.small_svd_reference(torch.zeros(shape), null_only)
            assert [tuple(f.shape) for f in fake] == [tuple(r.shape) for r in real]


@pytest.mark.parametrize("null_only, shape", [(True, (4, 8, 9)), (True, (2, 40, 12)),
                                               (False, (4, 3, 3))])
def test_small_svd_operator_passes_opcheck(null_only, shape):
    """``sfm::small_svd``'s schema, fake implementation and registrations
    agree with its CPU implementation (``torch.library.opcheck``)."""
    A = torch.as_tensor(np.random.default_rng(4).normal(size=shape).astype(f32))
    torch.library.opcheck(torch.ops.sfm.small_svd.default, (A, null_only))


@pytest.mark.parametrize("M, N, want", [(8, 9, 0), (32, 12, 0), (33, 12, 0), (2048, 9, 0),
                                        (2049, 9, 3 * (9 * 9 + 1) + 1),
                                        (65536, 12, 64 * (12 * 12 + 1) + 1)])
def test_scratch_follows_the_kernels_reductions(M, N, want):
    """The scratch the wrapper gives the kernel: none for a matrix that one
    reduction block takes (2048 rows), else every block's N x N R and
    scale exponent (1024 rows a block) and one int counter a matrix."""
    assert S._scratch_floats(1, M, N) == want
    assert S._scratch_floats(8, M, N) == 8 * want


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_null_vectors_against_plain(card, case):
    """B7 against the plain version on the card: finite unit vectors, |A v|
    within 1e-4 of the largest singular value of the plain one's, equal to
    1e-3 where the two smallest singular values are apart; the same bits
    on a second launch; no host synchronisation, and a CUDA graph capture
    of it replays the same bits twice (the tall reduction's counters are
    zeroed inside the graph)."""
    A = torch.as_tensor(CASES[case], device=card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = nullspace(A)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = S.small_svd_reference(A, True)[2][..., 0, :]
    s = torch.linalg.svdvals(A.double()).cpu().numpy()
    s_full = np.concatenate([s, np.zeros(s.shape[:-1] + (A.shape[-1] - s.shape[-1],))], -1)
    gap = (s_full[..., -2] - s_full[..., -1]) > 1e-3 * np.maximum(s_full[..., 0], 1e-30)
    An = A.cpu().numpy()
    w = want.cpu().numpy().astype(np.float64)
    want_res = np.linalg.norm(np.einsum("...mn,...n->...m", An.astype(np.float64), w), axis=-1)
    _unit_null_ok(An, got.cpu().numpy().astype(np.float64), want_res,
                  1e-4 * np.maximum(s_full[..., 0], 1e-30))
    np.testing.assert_allclose(got.cpu().numpy()[gap], w[gap], atol=1e-3)
    assert torch.equal(got, nullspace(A))
    g = torch.cuda.CUDAGraph()
    static = A.clone()
    nullspace(static)
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        out = nullspace(static)
    for _ in range(2):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)


@pytest.mark.cuda
def test_kernel_svd3_against_plain(card):
    """B7's 3 x 3 factors against the plain version on the card."""
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.normal(size=(4096, 3, 3)).astype(f32), device=card)
    U, Sv, Vh = S.svd3(A)
    u, s, vh = S.small_svd_reference(A, False)
    torch.testing.assert_close(Sv, s, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(Vh, vh, atol=1e-4, rtol=0)
    torch.testing.assert_close(U, u, atol=1e-4, rtol=0)
    torch.testing.assert_close(U @ torch.diag_embed(Sv) @ Vh, A, atol=1e-5, rtol=0)
