"""The six kernels of the PyTorch port, held against the JAX package's
Pallas kernels (interpret mode on the CPU).

On a CPU tensor each wrapper runs its plain PyTorch version, so these tests
check the plain versions' semantics; ``chip_smoke.py`` holds the CUDA
kernels against the same plain versions on the card."""

import dataclasses

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
from tests.test_torch_config import port_config

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


def _cli_relative_kernels():
    """The five relative kernels of an octave at the CLI's defaults (sigma0
    1.6, 3 scales an octave): radii 4, 6, 9, 12, 15."""
    sig = [1.6 * 2.0 ** (i / 3) for i in range(6)]
    return [JF._gaussian_kernel1d(float(np.sqrt(s**2 - sig[0] ** 2))) for s in sig[1:]]


@pytest.mark.parametrize("case", ["three_sigmas", "base_blur_radius_4", "cli_radii_4_to_15"])
def test_blur_plain_matches_pallas(case):
    """B1: zero-padded 'SAME' separable blur, all levels; atol 2e-5 is the
    f32 sum-order bound the JAX package holds its own kernel to. The cases
    are the shapes of call of a frame: ONE level of radius 4 (the base blur)
    and the five radii of an octave at the CLI's defaults."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(64, 256)).astype(np.float32)
    ks = {
        "three_sigmas": [JF._gaussian_kernel1d(s) for s in (1.2, 2.5, 4.8)],
        "base_blur_radius_4": [JF._gaussian_kernel1d(float(np.sqrt(1.6**2 - 1.0)))],
        "cli_radii_4_to_15": _cli_relative_kernels(),
    }[case]
    if case != "three_sigmas":
        want_radii = [4] if case == "base_blur_radius_4" else [4, 6, 9, 12, 15]
        assert [len(k) // 2 for k in ks] == want_radii
    want = np.asarray(pallas_blur_levels(jnp.asarray(img), ks, interpret=True))
    got = blur_cuda.blur_levels_reference(T(img), ks).numpy()
    assert got.shape == (len(ks), 64, 256)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_blur_taps_table_is_keyed_by_content():
    """The launch parameter of B1 is built once per distinct list of taps:
    other taps of the same lengths give another table (and another result),
    the same taps the same table; the table holds each level's radius and
    taps as the kernel reads them."""
    rng = np.random.default_rng(12)
    img = T(rng.normal(size=(40, 56)).astype(np.float32))
    a = [JF._gaussian_kernel1d(1.2), JF._gaussian_kernel1d(2.0)]
    b = [JF._gaussian_kernel1d(1.3), JF._gaussian_kernel1d(1.9)]
    assert [len(k) for k in a] == [len(k) for k in b]
    out_a, out_b = blur_cuda.blur_levels(img, a), blur_cuda.blur_levels(img, b)
    assert float((out_a - out_b).abs().max()) > 1e-3
    ta, tb = blur_cuda.taps_table(a), blur_cuda.taps_table(b)
    assert ta is not tb and ta is blur_cuda.taps_table([k.copy() for k in a])
    for table, ks in ((ta, a), (tb, b)):
        for lvl, k in enumerate(ks):
            assert table.radius[lvl] == len(k) // 2
            np.testing.assert_array_equal(np.asarray(table.k[lvl][: len(k)], np.float32), k)
    with pytest.raises(ValueError, match="radius"):
        blur_cuda.taps_table([np.ones(35, np.float32) / 35])
    with pytest.raises(ValueError, match="levels"):
        blur_cuda.taps_table([a[0]] * (blur_cuda.MAX_LEVELS + 1))


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


def _jax_block_max(resp, B=8):
    """The JAX package's two-stage block reduction (``ops/features.py``,
    ``_octave_candidates``) on a response map -> (cand, row in block, column
    in block), each (S, H/B, W/B)."""
    S, h, w = resp.shape
    hb, wb = h // B, w // B
    r4 = resp.reshape(S, h, wb, B)
    ax1 = jnp.argmax(r4, axis=3).astype(jnp.int32)
    r5 = jnp.max(r4, axis=3).reshape(S, hb, B, wb)
    ax2 = jnp.argmax(r5, axis=2).astype(jnp.int32)
    yy = jnp.arange(hb)[None, :, None] * B + ax2
    dx = ax1[jnp.arange(S)[:, None, None], yy, jnp.arange(wb)[None, None, :]]
    return np.asarray(jnp.max(r5, axis=2)), np.asarray(ax2), np.asarray(dx)


@pytest.mark.parametrize("shape", [(64, 128), (128, 256)])
def test_candidate_block_max_plain_matches_pallas_and_the_jax_reduction_exactly(shape):
    """B2 fused: each 8x8 block's largest masked response and its place,
    against the interpreted Pallas kernel followed by the JAX package's
    two-stage reduction: values and positions exactly equal (atol 0)."""
    rng = np.random.default_rng(3 + shape[0])
    dog = (rng.normal(size=(5, *shape)) * 0.05).astype(np.float32)
    resp = pallas_candidate_response(jnp.asarray(dog), 0.015, 10.0, border=8, interpret=True)
    want, want_dy, want_dx = _jax_block_max(resp)
    cand, pos = features_cuda.candidate_block_max_reference(T(dog), 0.015, 10.0, 8)
    assert cand.shape == pos.shape == (3, shape[0] // 8, shape[1] // 8)
    assert cand.dtype == torch.float32 and pos.dtype == torch.int32
    assert (want > 0).sum() > 20 and (want == 0).sum() > 20
    np.testing.assert_array_equal(cand.numpy(), want)
    np.testing.assert_array_equal(pos.numpy() // 8, want_dy)
    np.testing.assert_array_equal(pos.numpy() % 8, want_dx)


def test_candidate_block_max_ties_and_zero_blocks():
    """Among equal maxima of a block the lowest row that holds one wins,
    and in that row the lowest column (the two-stage reduction's pick, not
    the first in column-major order); a block of zeros gives position 0."""
    dog = np.zeros((3, 32, 128), np.float32)  # the Pallas kernel needs W % 128 == 0
    # equal isolated peaks in block (1, 1) of the one output layer: at
    # (row, column) (11, 14), (13, 9) and (13, 12); each is a 3x3x3 maximum
    # with a well-conditioned Hessian
    for y, x in ((11, 14), (13, 9), (13, 12)):
        dog[1, y, x] = 0.5
    cand, pos = features_cuda.candidate_block_max_reference(T(dog), 0.015, 10.0, 8)
    assert cand.shape == (1, 4, 16)
    assert float(cand[0, 1, 1]) == 0.5 and int(pos[0, 1, 1]) == (11 - 8) * 8 + (14 - 8)
    others = torch.ones(4, 16, dtype=torch.bool)
    others[1, 1] = False
    assert bool((cand[0][others] == 0).all()) and bool((pos[0][others] == 0).all())
    resp = pallas_candidate_response(jnp.asarray(dog), 0.015, 10.0, border=8, interpret=True)
    want, want_dy, want_dx = _jax_block_max(resp)
    np.testing.assert_array_equal(cand.numpy(), want)
    np.testing.assert_array_equal(pos.numpy(), want_dy * 8 + want_dx)
    # a lower column in a LOWER row must not win over a higher column above it
    assert int(pos[0, 1, 1]) % 8 == 6 and (13 - 8) * 8 + 1 != int(pos[0, 1, 1])


def test_octave_candidates_take_the_unfused_path_when_8_does_not_divide(monkeypatch):
    """``_octave_candidates`` keeps one candidate a block through the fused
    function when the block divides H and W, and falls back to the map and
    a top-k over every pixel when it does not (or ``topk_block`` <= 1)."""
    from structure_from_motion_tpu_torch.config import FrontendConfig
    from structure_from_motion_tpu_torch.ops import features

    calls = []
    for name in ("candidate_block_max", "candidate_response"):
        fn = getattr(features, name)
        monkeypatch.setattr(features, name,
                            lambda *a, _fn=fn, _n=name, **k: (calls.append(_n), _fn(*a, **k))[1])
    rng = np.random.default_rng(5)
    cfg = FrontendConfig(max_keypoints=64)
    for shape, block, want in (((6, 64, 96), 8, "candidate_block_max"),
                               ((6, 60, 96), 8, "candidate_response"),
                               ((6, 64, 96), 0, "candidate_response"),
                               ((6, 64, 96), 4, "candidate_response"),
                               ((6, 64, 96), 16, "candidate_response")):
        calls.clear()
        gauss = T(np.cumsum(rng.normal(size=shape) * 0.03, axis=0).astype(np.float32))
        out = features._octave_candidates(gauss, dataclasses.replace(cfg, topk_block=block), 64)
        assert calls == [want]
        dog, xx, yy, s_idx, resp, ok = out
        assert int(ok.sum()) > 5
        full = features_cuda.candidate_response_reference(dog, cfg.contrast_threshold,
                                                          cfg.edge_threshold, 8)
        assert torch.equal(full[s_idx[ok], yy[ok], xx[ok]], resp[ok])
        if block > 1 and shape[1] % block == 0:
            # one candidate a block, and it is the block's maximum
            ids = (s_idx * 10**6 + (yy // block) * 10**3 + xx // block)[ok]
            assert len(set(ids.tolist())) == int(ok.sum())
            want_max = features_cuda.block_argmax(full, block)[0]
            assert torch.equal(want_max[s_idx[ok], yy[ok] // block, xx[ok] // block], resp[ok])


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
    got = matching.match_descriptors(T(ref), T(que), T(mr), T(mq), port_config(cfg))
    w1, w2, _ = matching.match_top2_reference(T(ref), T(que), T(mq))
    sep = ((w2 - w1) > 1e-3).numpy()
    assert np.asarray(want.valid).sum() > 50
    np.testing.assert_array_equal(got.valid.numpy()[sep], np.asarray(want.valid)[sep])
    np.testing.assert_array_equal(got.target.numpy()[sep], np.asarray(want.target)[sep])


@pytest.mark.parametrize("seed", [15, 16])
def test_match_top2_and_descriptors_match_pallas_at_the_pipelines_scale(seed):
    """B3 on x512 descriptors, the scale the frontend feeds the matcher
    (``features.py``: ``desc * 512``): every d^2 and its rounding grow by
    512^2, so the unit-norm tolerances (rtol 1e-5 / atol 1e-4, separation
    1e-3) are scaled by 512^2; the matcher's decisions must be equal on
    every separated row."""
    ref, que, mr, mq = _descriptors(np.random.default_rng(seed))
    ref, que, sc = ref * np.float32(512), que * np.float32(512), 512.0**2
    w1, w2, wj = (np.asarray(a) for a in JM.pallas_match_top2(
        jnp.asarray(ref), jnp.asarray(que), jnp.asarray(mq), interpret=True))
    g1, g2, gj = (a.numpy() for a in matching.match_top2_reference(T(ref), T(que), T(mq)))
    np.testing.assert_allclose(g1, w1, rtol=1e-5, atol=1e-4 * sc)
    np.testing.assert_allclose(g2, w2, rtol=1e-5, atol=1e-4 * sc)
    sep = (w2 - w1) > 1e-3 * sc
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(gj[sep], wj[sep])
    cfg = MatcherConfig(ratio=0.8, impl="pallas")
    want = JM.match_descriptors(jnp.asarray(ref), jnp.asarray(que), jnp.asarray(mr),
                                jnp.asarray(mq), cfg)
    got = matching.match_descriptors(T(ref), T(que), T(mr), T(mq), port_config(cfg))
    assert np.asarray(want.valid).sum() > 50
    np.testing.assert_array_equal(got.valid.numpy()[sep], np.asarray(want.valid)[sep])
    np.testing.assert_array_equal(got.target.numpy()[sep], np.asarray(want.target)[sep])
    np.testing.assert_allclose(got.distance.numpy()[sep & mr], np.asarray(want.distance)[sep & mr],
                               rtol=1e-4)


def test_match_descriptors_batched_equals_per_view():
    """The batched (B, Nr, D) call the engine makes over all prior views
    equals B separate calls."""
    rng = np.random.default_rng(7)
    views = [_descriptors(rng) for _ in range(3)]
    que, mq = views[0][1], views[0][3]
    cfg = port_config(MatcherConfig(ratio=0.8))
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


def test_ba_blocks_plain_matches_pallas_with_foreign_camera_ids():
    """B4 at V = 40 with camera ids outside [0, V) on a tenth of the
    observations: they get their per-observation blocks like any other, and
    enter no camera sum (U, b_c). Same tolerance as above. The cost is the
    one output where the two sides differ on such input: the kernels (TPU and
    CUDA) add up the cameras' shares, which leaves a weighted foreign
    observation out; the plain version sums every residual. The pipeline
    never gives a foreign id a weight, so each is held to its own rule."""
    rng = np.random.default_rng(18)
    V, O = 40, 1536
    cam, C, q, X, uv, w = _ba_inputs(rng, O, V)
    foreign = rng.random(O) < 0.1
    cam = np.where(foreign, rng.choice(np.array([-1, -7, V, V + 3], np.int32), O), cam)
    args = (cam.astype(np.int32), C, q, X, uv, w)
    want = pallas_ba_blocks(*(jnp.asarray(a) for a in args), n_views=V, huber_delta=0.01,
                            interpret=True)
    got = ba_cuda.ba_blocks_reference(*(T(a) for a in args), V, 0.01)
    for name, g, wv in zip(["U", "b_c", "DtD", "W", "b_p"], got, want):
        wv = np.asarray(wv, np.float32)
        scale = max(1.0, float(np.abs(wv).max()))
        assert np.abs(g.numpy() - wv).max() <= 1e-3 * scale, name
    # the camera sums hold exactly the observations whose id is a camera
    own = ~foreign
    inside = ba_cuda.ba_blocks_reference(*(T(a[own]) for a in args), V, 0.01)
    np.testing.assert_allclose(got[0].numpy(), inside[0].numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), inside[1].numpy(), rtol=1e-5, atol=1e-4)
    assert (w[foreign] > 0).sum() > 50 and float(got[5]) > float(inside[5])
    assert abs(float(want[5]) - float(inside[5])) <= 1e-3 * max(1.0, float(inside[5]))
    assert np.abs(got[3].numpy()[foreign]).max() > 0


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


@pytest.mark.parametrize("rows", [45, 70])
def test_reduce_cam_plain_matches_pallas_on_ragged_rows(rows):
    """B6 with ``rows`` not a multiple of 32 (the width of the chunks the
    CUDA kernel walks), one camera with no filled slot and one with every
    slot filled; atol 1e-4 as above."""
    V, O = 6, 512
    rng = np.random.default_rng(rows)
    _, W, _, y, _ = _matvec_inputs(rng, O, V)
    counts = np.array([rows - 7, 0, rows, 23, rows - 1, 17])
    n = int(counts.sum())
    # the valid observations in a shuffled order, then unfilled padding slots
    cam = np.concatenate([rng.permutation(np.repeat(np.arange(V), counts)),
                          rng.integers(0, V, O - n)]).astype(np.int32)
    valid = np.arange(O) < n
    W[~valid] = 0.0
    w21 = W.reshape(O, 21)
    assert n < O and counts[1] == 0 and counts.max() == counts[2] == rows and rows % 32
    want = np.asarray(pallas_reduce_cam(jnp.asarray(cam), jnp.asarray(w21.T), jnp.asarray(y.T), V,
                                        interpret=True))
    perm, mask = compute_cam_ell(T(cam), T(valid), V, rows)
    assert not mask.view(V, rows)[1].any() and mask.view(V, rows)[2].all()
    got = ba_matvec.reduce_cam_reference(T(w21), T(y), perm, mask, V).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(got[1]).max() == 0.0


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
        (features_cuda.candidate_block_max, features_cuda.candidate_block_max_reference,
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


def test_kernel_variants_still_find_their_text():
    """``tools/kernel_variants.py`` makes its variants by substituting text
    of ``csrc/blur.cu``, ``csrc/cand.cu``, ``csrc/ba_blocks.cu`` and
    ``csrc/ba_matvec.cu``; every
    substitution must still find its text and change the source."""
    from structure_from_motion_tpu_torch.tools import kernel_variants as kv

    tree = (kernels.CSRC / "blur.cu").read_text()
    for tile in kv.B1_TILES:
        assert f"launch<{tile.partition('+')[0]}>" in kv.blur_source(tile)
    sources = {kv.blur_source("256,64,128,8,8,2", pairs) for pairs in kv.B1_ABLATIONS.values()}
    assert len(sources) == len(kv.B1_ABLATIONS) and tree not in sources
    assert len({kv.reduce_source(v) for v in kv.B6_VARIANTS}) == len(kv.B6_VARIANTS)
    for tile in kv.B2_TILES:
        src = kv.cand_source(tile)
        c, r, u = tile.split(",")[:3]
        assert f"constexpr int kC = {c}, kR = {r}, kU = {u};" in src
    sources = {kv.cand_source("2,8,2", pairs) for pairs in kv.B2_CHANGES.values()}
    assert len(sources) == len(kv.B2_CHANGES)
    assert len({kv.b4_source(pairs) for pairs in kv.B4_CHANGES.values()}) == len(kv.B4_CHANGES)
    assert len({kv.cand_source(t) for t in kv.B2_TILES}) == len(kv.B2_TILES)
    with pytest.raises(RuntimeError, match="no longer holds"):
        kv.blur_source("256,64,128,8,8,2", [("not in the source", "")])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: without the CUDA toolkit the kernel build raises."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
