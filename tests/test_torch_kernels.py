"""The six kernels of the PyTorch port, held against the JAX package's
Pallas kernels (interpret mode on the CPU).

On a CPU tensor each wrapper runs its plain PyTorch version, so these tests
check the plain versions' semantics; ``chip_smoke.py`` holds the CUDA
kernels against the same plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.config import MatcherConfig
from structure_from_motion_tpu.ops import features as JF
from structure_from_motion_tpu.ops import matching as JM
from structure_from_motion_tpu.ops.ba_matvec_pallas import pallas_expand_cam, pallas_reduce_cam
from structure_from_motion_tpu.ops.ba_pallas import pallas_ba_blocks
from structure_from_motion_tpu.ops.blur_pallas import pallas_blur_levels
from structure_from_motion_tpu.ops.features_pallas import pallas_candidate_response
from structure_from_motion_tpu_torch import kernels
from structure_from_motion_tpu_torch.ops import (
    ba_cuda,
    ba_matvec,
    blur_cuda,
    features_cuda,
    matching,
)
from structure_from_motion_tpu_torch.ops.ba import compute_cam_ell

T = torch.from_numpy


def _descriptors(rng, nr=256, nq=512):
    ref = np.abs(rng.normal(size=(nr, 128))).astype(np.float32)
    que = np.abs(rng.normal(size=(nq, 128))).astype(np.float32)
    # half of the queries are noisy copies of reference rows: real matches
    perm = rng.permutation(nr)[: nq // 2]
    que[: nq // 2] = ref[perm] + 0.3 * np.abs(rng.normal(size=(nq // 2, 128)))
    # unit norm: the stated d^2 tolerances are for unit-norm descriptors (the
    # pipeline's x512 scale multiplies every d^2 and its rounding by 512^2)
    unit = lambda d: (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    return unit(ref), unit(que), rng.random(nr) < 0.9, rng.random(nq) < 0.9


def _ba_inputs(rng, O=1024, V=8):
    cam = rng.integers(0, V, O).astype(np.int32)
    Cv = rng.normal(size=(V, 3)).astype(np.float32)
    qv = (np.float32([1, 0, 0, 0]) + 0.05 * rng.normal(size=(V, 4))).astype(np.float32)
    X = (rng.normal(size=(O, 3)) * [3, 2, 1] + [0, 0, 10]).astype(np.float32)
    uv = ((X[:, :2] - Cv[cam, :2]) / (X[:, 2:] - Cv[cam, 2:])
          + 0.01 * rng.normal(size=(O, 2))).astype(np.float32)
    w = (rng.random(O) < 0.7).astype(np.float32)
    return cam, Cv[cam], qv[cam], X, uv, w


def test_blur_plain_matches_pallas():
    """B1: zero-padded 'SAME' separable blur, all levels; atol 2e-5 is the
    f32 sum-order bound the JAX package holds its own kernel to."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(64, 256)).astype(np.float32)
    ks = [JF._gaussian_kernel1d(s) for s in (1.2, 2.5, 4.8)]
    want = np.asarray(pallas_blur_levels(jnp.asarray(img), ks, interpret=True))
    got = blur_cuda.blur_levels_reference(T(img), ks).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_candidate_response_plain_matches_pallas_exactly():
    """B2: the masked candidate response must be bit-identical (atol 0),
    both extremum polarities, all border rows and columns."""
    rng = np.random.default_rng(3)
    dog = (rng.normal(size=(5, 64, 128)) * 0.05).astype(np.float32)
    want = np.asarray(pallas_candidate_response(jnp.asarray(dog), 0.015, 10.0, border=8,
                                                interpret=True))
    got = features_cuda.candidate_response_reference(T(dog), 0.015, 10.0, 8).numpy()
    assert (want > 0).sum() > 20
    np.testing.assert_array_equal(got, want)


def test_match_top2_plain_matches_pallas():
    """B3: d1^2/d2^2 to rtol 1e-5 / atol 1e-4 (f32 dot-product order); the
    argmin must agree wherever the top two are separated by > 1e-3."""
    ref, que, _, mq = _descriptors(np.random.default_rng(5))
    w1, w2, wj = (np.asarray(a) for a in JM.pallas_match_top2(
        jnp.asarray(ref), jnp.asarray(que), jnp.asarray(mq), interpret=True))
    g1, g2, gj = (a.numpy() for a in matching.match_top2_reference(T(ref), T(que), T(mq)))
    np.testing.assert_allclose(g1, w1, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g2, w2, rtol=1e-5, atol=1e-4)
    sep = (w2 - w1) > 1e-3
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(gj[sep], wj[sep])


def test_match_descriptors_matches_jax():
    """Ratio test + per-query dedup against the JAX matcher on the Pallas
    path: equal target/valid on every row whose top two are separated."""
    ref, que, mr, mq = _descriptors(np.random.default_rng(6))
    cfg = MatcherConfig(ratio=0.8, impl="pallas")
    want = JM.match_descriptors(jnp.asarray(ref), jnp.asarray(que), jnp.asarray(mr),
                                jnp.asarray(mq), cfg)
    got = matching.match_descriptors(T(ref), T(que), T(mr), T(mq), cfg)
    w1, w2, _ = matching.match_top2_reference(T(ref), T(que), T(mq))
    sep = ((w2 - w1) > 1e-3).numpy()
    assert np.asarray(want.valid).sum() > 50
    np.testing.assert_array_equal(got.valid.numpy()[sep], np.asarray(want.valid)[sep])
    np.testing.assert_array_equal(got.target.numpy()[sep], np.asarray(want.target)[sep])


def test_match_descriptors_batched_equals_per_view():
    """The batched (B, Nr, D) call the engine makes over all prior views
    equals B separate calls."""
    rng = np.random.default_rng(7)
    views = [_descriptors(rng) for _ in range(3)]
    que, mq = views[0][1], views[0][3]
    cfg = MatcherConfig(ratio=0.8)
    ref = T(np.stack([v[0] for v in views]))
    mr = T(np.stack([v[2] for v in views]))
    batched = matching.match_descriptors(ref, T(que), mr, T(mq), cfg)
    for b in range(3):
        one = matching.match_descriptors(ref[b], T(que), mr[b], T(mq), cfg)
        for x, y in zip(batched, one):
            assert torch.equal(x[b], y)


def test_ba_blocks_plain_matches_pallas():
    """B4: every block to 1e-3 x max(1, |value|), the tolerance the JAX
    package holds its own kernel to (f32 accumulation order)."""
    cam, C, q, X, uv, w = _ba_inputs(np.random.default_rng(8))
    want = pallas_ba_blocks(*(jnp.asarray(a) for a in (cam, C, q, X, uv, w)),
                            n_views=8, huber_delta=0.01, interpret=True)
    got = ba_cuda.ba_blocks_reference(*(T(a) for a in (cam, C, q, X, uv, w)), 8, 0.01)
    for name, g, wv in zip(["U", "b_c", "DtD", "W", "b_p", "cost"], got, want):
        wv = np.asarray(wv, np.float32)
        scale = max(1.0, float(np.abs(wv).max()))
        assert np.abs(g.numpy() - wv).max() <= 1e-3 * scale, name


def _matvec_inputs(rng, O, V):
    cam = rng.integers(0, V, O).astype(np.int32)
    W = rng.normal(size=(O, 7, 3)).astype(np.float32)
    x = rng.normal(size=(V, 7)).astype(np.float32)
    y = rng.normal(size=(O, 3)).astype(np.float32)
    valid = rng.random(O) < 0.9
    return cam, W, x, y, valid


@pytest.mark.parametrize("O", [1024, 1536])
def test_ba_matvec_plain_matches_pallas(O):
    """B5/B6 at V = 37 (the case of tests/test_global_ba.py:340-364): the
    expand to atol 1e-5 (a 7-term dot product in another order), the reduce
    to atol 1e-4 (up to ~O/V terms per camera in another order). B6 runs
    over the camera-major view built by compute_cam_ell; invalid slots
    enter neither side (their W rows are zero, as B4 writes them)."""
    V = 37
    cam, W, x, y, valid = _matvec_inputs(np.random.default_rng(O), O, V)
    W[~valid] = 0.0
    w21 = W.reshape(O, 21)
    want_t = np.asarray(pallas_expand_cam(jnp.asarray(cam), jnp.asarray(w21.T), jnp.asarray(x),
                                          interpret=True)).T
    got_t = ba_matvec.expand_cam_reference(T(cam), T(w21), T(x)).numpy()
    np.testing.assert_allclose(got_t, want_t, atol=1e-5)
    want_c = np.asarray(pallas_reduce_cam(jnp.asarray(cam), jnp.asarray(w21.T),
                                          jnp.asarray(y.T), V, interpret=True))
    rows = int(np.bincount(cam[valid], minlength=V).max())
    perm, mask = compute_cam_ell(T(cam), T(valid), V, rows)
    got_c = ba_matvec.reduce_cam_reference(T(w21), T(y), perm, mask, V).numpy()
    np.testing.assert_allclose(got_c, want_c, atol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    """Dispatch is by device only: CPU tensors run the plain version and no
    kernel launch is counted; a tensor on another device raises."""
    rng = np.random.default_rng(9)
    img = T(rng.normal(size=(24, 40)).astype(np.float32))
    dog = T((rng.normal(size=(5, 24, 40)) * 0.05).astype(np.float32))
    ref, que, _, mq = (T(a) for a in _descriptors(rng, 64, 32))
    ba_in = [T(a) for a in _ba_inputs(rng, 300, 4)]
    ks = [JF._gaussian_kernel1d(1.5)]
    cam, W, x, y, valid = (T(a) for a in _matvec_inputs(rng, 200, 5))
    w21 = W.reshape(200, 21)
    perm, mask = compute_cam_ell(cam, valid, 5, 64)
    calls = [
        (blur_cuda.blur_levels, blur_cuda.blur_levels_reference, (img, ks)),
        (features_cuda.candidate_response, features_cuda.candidate_response_reference,
         (dog, 0.015, 10.0, 8)),
        (matching.match_top2, matching.match_top2_reference, (ref, que, mq)),
        (ba_cuda.ba_blocks, ba_cuda.ba_blocks_reference, (*ba_in, 4, 0.01)),
        (ba_matvec.expand_cam, ba_matvec.expand_cam_reference, (cam, w21, x)),
        (ba_matvec.reduce_cam, ba_matvec.reduce_cam_reference, (w21, y, perm, mask, 5)),
    ]
    for wrapper, plain, args in calls:
        before = wrapper.launches
        got, want = wrapper(*args), plain(*args)
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        for g, p in zip(got, want):
            assert torch.equal(g, p)
        assert wrapper.launches == before == 0
    with pytest.raises(ValueError, match="unsupported device"):
        blur_cuda.blur_levels(torch.empty(8, 8, device="meta"), ks)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: without the CUDA toolkit the kernel build raises."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
