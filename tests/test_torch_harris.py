"""The port's Harris / steered-BRIEF frontend and its Hamming, cross-check
and squared-distance matching against the JAX package's.

The JAX side runs on a rendered 256x512 frame with 3 octaves, where every
octave (256x512, 128x256, 64x128) keeps its blurs on the exact Pallas blur
(``blur_impl="pallas"``, interpret mode on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.config import FrontendConfig, MatcherConfig
from structure_from_motion_tpu.io.synthetic import synthetic_scene_sequence
from structure_from_motion_tpu.ops import features as JF
from structure_from_motion_tpu.ops import matching as JM
from structure_from_motion_tpu_torch.ops import features as TF
from structure_from_motion_tpu_torch.ops import matching as TM
from tests.test_torch_config import port_config

T = torch.from_numpy

CFG = FrontendConfig(detector="harris", max_keypoints=256, num_octaves=3, descriptor_dim=256,
                     upsample_first_octave=False, blur_impl="pallas")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    imgs, *_ = synthetic_scene_sequence(n_frames=1, size=(256, 512), seed=3, loops=0.21)
    img = imgs[0].astype(np.float32)
    return img / img.max()


@pytest.fixture(scope="module")
def both(frame):
    jk, jd = jax.device_get(JF.detect_and_describe(jnp.asarray(frame), CFG))
    tk, td = TF.detect_and_describe(T(frame), port_config(CFG))
    return jk, np.asarray(jd), tk, td.numpy()


def test_harris_response_matches_jax(frame):
    """The Harris response map (three structure-tensor blurs through the
    Pallas blur in JAX, three lanes of B1's plain version here) to
    1e-5 x the map's largest magnitude."""
    want = np.asarray(JF._harris_response(jnp.asarray(frame), impl="pallas"))
    got = TF._harris_response(T(frame)).numpy()
    assert got.shape == want.shape == frame.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_brief_pattern_bit_for_bit():
    """numpy's ``default_rng(7)``: the same 256 test pairs, bit for bit."""
    want = np.asarray(JF._brief_pattern(256, 31.0))
    got = TF._brief_pattern(256, 31.0)
    assert got.dtype == np.float32 and got.shape == (256, 4)
    np.testing.assert_array_equal(got, want)


def test_harris_keypoints_match_jax(both):
    """>= 98% of the JAX keypoints have a port keypoint within 1e-3 px with
    the same angle to 1e-4 rad (integer corner positions, exact top-k)."""
    jk, _, tk, _ = both
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert jm.sum() == 256 and tm.sum() == 256
    jxy, txy = np.asarray(jk.xy)[jm], tk.xy.numpy()[tm]
    d = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
    j = d.argmin(1)
    found = (d.min(1) < 1e-3) & (np.abs(np.asarray(jk.angle)[jm] - tk.angle.numpy()[tm][j]) < 1e-4)
    assert found.mean() >= 0.98, found.mean()


def test_brief_bits_match_jax(both):
    """Descriptor bits of the keypoints found at the same place: BRIEF
    compares single samples, so agreement is a share: >= 99.5% of the
    bits equal, and every code is +-1 (0 on masked rows)."""
    jk, jd, tk, td = both
    assert td.shape == (256, 256)
    assert set(np.unique(td[tk.mask.numpy()])) <= {-1.0, 1.0}
    jxy, txy = np.asarray(jk.xy), tk.xy.numpy()
    d = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
    j = d.argmin(1)
    same = d.min(1) < 1e-3
    assert same.mean() >= 0.98
    agree = (jd[same] == td[j[same]]).mean()
    assert agree >= 0.995, agree


def test_hamming_distance_matches_bit_count():
    """Twin of ``tests/test_features.py::test_hamming_distance_matches_bit_count``,
    and equal to the JAX function."""
    rng = np.random.default_rng(0)
    a = np.where(rng.random((16, 64)) > 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.random((16, 64)) > 0.5, 1.0, -1.0).astype(np.float32)
    m = np.ones(16, bool)
    ham = TM.hamming_distances(T(a), T(b), T(m), T(m)).numpy()
    np.testing.assert_array_equal(ham, (a[:, None, :] != b[None, :, :]).sum(-1))
    np.testing.assert_array_equal(
        ham, np.asarray(JM.hamming_distances(*(jnp.asarray(x) for x in (a, b, m, m)))))


def test_cross_check_mutual_only():
    """Twin of ``tests/test_matching.py::test_cross_check_mutual_only``:
    every accepted match is mutual nearest; the same matches as the JAX
    matcher, with L2 and with Hamming codes."""
    rng = np.random.default_rng(1)
    ref = rng.normal(size=(32, 8)).astype(np.float32)
    que = np.vstack([ref[:16] + 0.01 * rng.normal(size=(16, 8)),
                     rng.normal(size=(16, 8))]).astype(np.float32)
    ones = np.ones(32, bool)
    for metric, r, q in (("l2", ref, que), ("hamming", np.sign(ref), np.sign(que))):
        cfg = MatcherConfig(ratio=0.99, cross_check=True, metric=metric)
        res = TM.match_descriptors(T(r), T(q), T(ones), T(ones), port_config(cfg))
        want = JM.match_descriptors(*(jnp.asarray(x) for x in (r, q, ones, ones)), cfg)
        np.testing.assert_array_equal(res.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(res.target.numpy(), np.asarray(want.target))
        if metric == "l2":
            t, v = res.target.numpy(), res.valid.numpy()
            assert v.sum() >= 12
            d2 = TM.squared_distances(T(r), T(q), T(ones), T(ones)).numpy()
            for i in np.where(v)[0]:
                assert d2[:, t[i]].argmin() == i


def test_squared_distances_match_jax_and_the_top2():
    """Twin of ``tests/test_matching.py`` 's squared-distance checks:
    masked (Nr, Nq) distances equal to the JAX function's (rtol 1e-5), and
    the matcher's top-2 plain version gives their minimum, second minimum
    and argmin."""
    rng = np.random.default_rng(2)
    d1 = np.abs(rng.normal(size=(256, 128))).astype(np.float32)
    d2 = np.abs(rng.normal(size=(256, 128))).astype(np.float32)
    mr = np.ones(256, bool)
    mq = np.ones(256, bool)
    mq[200:] = False
    ds = TM.squared_distances(T(d1), T(d2), T(mr), T(mq)).numpy()
    want = np.asarray(JM.squared_distances(*(jnp.asarray(x) for x in (d1, d2, mr, mq))))
    np.testing.assert_allclose(ds, want, rtol=1e-5, atol=1e-3)
    assert (ds[:, 200:] >= 3e38).all()
    g1, g2, gj = TM.match_top2_reference(T(d1), T(d2), T(mq))
    np.testing.assert_allclose(g1.numpy(), ds.min(1), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(g2.numpy(), np.partition(ds, 1, axis=1)[:, 1], rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_array_equal(gj.numpy(), ds.argmin(1))
