"""The port's DoG frontend against the JAX frontend on a rendered frame.

The JAX side is pinned to the semantics it ships on its accelerator: the
Pallas blur and candidate kernels with f32 extremum windows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.config import FrontendConfig
from structure_from_motion_tpu.io.synthetic import synthetic_scene_sequence
from structure_from_motion_tpu.ops import features as JF
from structure_from_motion_tpu_torch.ops import features as TF
from tests.test_torch_config import port_config

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frontends():
    imgs, *_ = synthetic_scene_sequence(n_frames=1, size=(256, 384), seed=3, loops=0.21)
    img = imgs[0].astype(np.float32)
    cfg = FrontendConfig(max_keypoints=256, num_octaves=2, blur_impl="pallas",
                         extrema_impl="pallas", extrema_dtype="f32")
    jk, jd = jax.device_get(JF.detect_and_describe(jnp.asarray(img), cfg))
    tk, td = TF.detect_and_describe(T(img), port_config(cfg))
    return jk, np.asarray(jd), tk, td.numpy()


def test_keypoints_match_jax(frontends):
    """>= 95% of the JAX keypoints have a port keypoint at the same octave
    and level (scale within 1e-3 relative) within 0.05 px."""
    jk, _, tk, _ = frontends
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert jm.sum() == 256 and tm.sum() == 256
    jxy, txy = np.asarray(jk.xy)[jm], tk.xy.numpy()[tm]
    jsc, tsc = np.asarray(jk.scale)[jm], tk.scale.numpy()[tm]
    d = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
    same_scale = np.abs(jsc[:, None] / tsc[None] - 1.0) < 1e-3
    found = ((d < 0.05) & same_scale).any(1)
    assert found.mean() >= 0.95, found.mean()


def test_keypoints_match_jax_at_a_block_other_than_8():
    """``topk_block`` = 4 (the response map reduced by two single-axis
    reductions, in both packages): >= 95% of the JAX keypoints have a port
    keypoint within 0.05 px."""
    imgs, *_ = synthetic_scene_sequence(n_frames=1, size=(128, 192), seed=3, loops=0.21)
    img = imgs[0].astype(np.float32)
    cfg = FrontendConfig(max_keypoints=128, num_octaves=1, topk_block=4, blur_impl="pallas",
                         extrema_impl="pallas", extrema_dtype="f32")
    jk, _ = jax.device_get(JF.detect_and_describe(jnp.asarray(img), cfg))
    tk, _ = TF.detect_and_describe(T(img), port_config(cfg))
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert jm.sum() == tm.sum() > 64
    d = np.linalg.norm(np.asarray(jk.xy)[jm][:, None] - tk.xy.numpy()[tm][None], axis=-1)
    assert (d < 0.05).any(1).mean() >= 0.95


def test_descriptors_match_jax(frontends):
    """Descriptors of matched keypoints (same position, scale and angle)
    agree to max-abs 2e-2 on the unit-norm descriptor (the outputs carry a
    x512 scale). The bound covers the bf16 gradient storage: a sampled
    gradient whose f32 value differs in the last bits between the two
    blurs can round to the neighbouring bf16 value (2^-8 relative)."""
    jk, jd, tk, td = frontends
    jxy, txy = np.asarray(jk.xy), tk.xy.numpy()
    ja, ta = np.asarray(jk.angle), tk.angle.numpy()
    pairs = 0
    for i in np.where(np.asarray(jk.mask))[0]:
        near = np.linalg.norm(txy - jxy[i], axis=1) < 0.05
        dang = np.abs(np.angle(np.exp(1j * (ta - ja[i]))))
        cand = np.where(near & (dang < 1e-3) & tk.mask.numpy())[0]
        if cand.size:
            pairs += 1
            assert np.abs(td[cand[0]] - jd[i]).max() / 512.0 <= 2e-2
    assert pairs >= 0.95 * 256


def test_upsample_matches_jax_resize():
    """The 2x bilinear upsample equals jax.image.resize(..., "linear"),
    borders included (both drop the out-of-image tap)."""
    img = np.random.default_rng(0).random((17, 23)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (34, 46), "linear"))
    np.testing.assert_allclose(TF._upsample2x(T(img)).numpy(), want, atol=1e-6)


def test_flat_gradients_bf16_match_jax():
    """Gradients are differenced and stored in bf16 exactly as the JAX
    package does (its "pair" buffer holds the per-pixel (gx, gy) in cols 0:2)."""
    rng = np.random.default_rng(1)
    octs = [rng.random((4, 16, 24)).astype(np.float32), rng.random((4, 8, 12)).astype(np.float32)]
    want = np.asarray(JF._flat_gradients([jnp.asarray(o) for o in octs], "pair", "bf16"))[:, :2]
    got = TF._flat_gradients([T(o) for o in octs], "bf16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_subpixel_fit_matches_jax():
    """3-D subpixel fit with relocation on a flat two-octave DoG, candidates
    near every border included (clamped gathers): offsets to 1e-5."""
    rng = np.random.default_rng(2)
    dogs = [rng.normal(size=(5, 32, 48)).astype(np.float32),
            rng.normal(size=(5, 16, 24)).astype(np.float32)]
    flat = np.concatenate([d.reshape(-1) for d in dogs])
    n = 64
    o = rng.integers(0, 2, n)
    h = np.array([32, 16])[o]
    w = np.array([48, 24])[o]
    base = np.array([0, dogs[0].size])[o]
    s = rng.integers(0, 3, n)
    y = rng.integers(2, h - 2)
    x = rng.integers(2, w - 2)
    args = [base, h, w, h * w]
    want = JF._subpixel_offset_3d(jnp.asarray(flat), *(jnp.asarray(a, jnp.int32) for a in args), 3,
                                  *(jnp.asarray(a, jnp.int32) for a in (s, y, x)))
    got = TF._subpixel_offset_3d(T(flat), *(torch.as_tensor(a) for a in args), 3,
                                 *(torch.as_tensor(a) for a in (s, y, x)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-5)


def test_hist_peaks_match_jax():
    """Orientation histogram peaks (primary, secondary, multi-peak flag)."""
    rng = np.random.default_rng(3)
    mag = rng.random((40, 256)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (40, 256)).astype(np.float32)
    want = JF._hist_peaks(jnp.asarray(mag), jnp.asarray(ang))
    got = TF._hist_peaks(T(mag), T(ang))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# -- sampling="shared": one unrotated grid for orientation and descriptor ----


def _shared_inputs(grad_dtype, n=64, seed=5):
    """Two random octave stacks (levels [0, S], S = 3; widths not multiples
    of 64, so the JAX sampler's chunks cross image rows) and n keypoints,
    some with grids straddling the borders, as both packages' flat
    pyramids."""
    rng = np.random.default_rng(seed)
    octs = [rng.random((4, 96, 100)).astype(np.float32), rng.random((4, 48, 50)).astype(np.float32)]
    oct_idx = rng.integers(0, 2, n)
    hw = np.array([[96, 100], [48, 50]])[oct_idx]
    x = rng.uniform(1, hw[:, 1] - 1).astype(np.float32)
    y = rng.uniform(1, hw[:, 0] - 1).astype(np.float32)
    sig = rng.uniform(1.2, 3.5, n).astype(np.float32)
    s = rng.integers(0, 4, n)
    jpyr = JF._flat_pyramid([jnp.asarray(o) for o in octs], jnp.asarray(oct_idx, jnp.int32),
                            JF._flat_gradients([jnp.asarray(o) for o in octs], "chunk64",
                                               grad_dtype))
    tocts = [T(o) for o in octs]
    tpyr = TF._flat_pyramid(tocts, T(oct_idx), TF._flat_gradients(tocts, grad_dtype))
    return jpyr, tpyr, (s, x, y, sig)


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
def test_shared_grid_samples_match_jax(grad_dtype):
    """The shared grid's (gx, gy) samples (18 x 18 at 0.95 sigma) against
    the JAX package's chunk64 sampler. f32 buffer: atol 1e-6 (the four taps
    summed in another order). bf16 buffer (the default): the bilinear
    weights are cast to bf16 and the f32 sum is rounded to bf16 in both,
    so they agree to one bf16 step (2^-8 relative) where the two f32 sums
    straddle a rounding boundary, and exactly on >= 99% of the values."""
    jpyr, tpyr, (s, x, y, sig) = _shared_inputs(grad_dtype)
    want, jdx, jdy = JF._sample_shared_grid(jpyr, jnp.asarray(s, jnp.int32), jnp.asarray(x),
                                           jnp.asarray(y), jnp.asarray(sig), 18, 0.95)
    got, dxs, dys = TF._sample_shared_grid(tpyr, T(s), T(x), T(y), T(sig), 18, 0.95)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(dxs.numpy(), np.asarray(jdx))
    np.testing.assert_array_equal(dys.numpy(), np.asarray(jdy))
    assert got.dtype == torch.float32 and got.shape == want.shape == (64, 324, 2)
    assert (want == 0).any() and (want != 0).mean() > 0.5  # borders reached, most inside
    if grad_dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2.0**-8, atol=1e-30)
        assert (got.numpy() == want).mean() >= 0.99


def test_shared_orientation_and_descriptors_match_jax():
    """On the same samples: the 36-bin orientation peaks (angles atol 1e-5,
    the second-peak flags equal) and the 128-d descriptors re-binned under
    each keypoint's angle (atol 1e-5 on the unit-norm descriptor, x512 in
    the outputs) equal the JAX package's."""
    rng = np.random.default_rng(7)
    n = 64
    g = rng.normal(size=(n, 324, 2)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    dxs, dys = TF._shared_offsets(18, 0.95, "cpu")
    jdx, jdy = jnp.asarray(dxs.numpy()), jnp.asarray(dys.numpy())
    want = JF._orientation_from_samples(jnp.asarray(g), jdx, jdy)
    got = TF._orientation_from_samples(T(g), dxs, dys)
    for a, b in zip(got[:2], want[:2]):
        d = np.angle(np.exp(1j * (a.numpy() - np.asarray(b))))
        assert np.abs(d).max() <= 1e-5
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    wd = JF._descriptors_from_samples(jnp.asarray(g), jdx, jdy, jnp.asarray(angle),
                                      jnp.asarray(valid))
    td = TF._descriptors_from_samples(T(g), dxs, dys, T(angle), T(valid))
    np.testing.assert_allclose(td.numpy() / 512.0, np.asarray(wd) / 512.0, atol=1e-5)
    assert (td.numpy()[~valid] == 0).all()


@pytest.fixture(scope="module")
def shared_frontends():
    imgs, *_ = synthetic_scene_sequence(n_frames=1, size=(256, 384), seed=3, loops=0.21)
    img = imgs[0].astype(np.float32)
    cfg = FrontendConfig(max_keypoints=256, num_octaves=2, blur_impl="pallas",
                         extrema_impl="pallas", extrema_dtype="f32", sampling="shared")
    jk, jd = jax.device_get(JF.detect_and_describe(jnp.asarray(img), cfg))
    tk, td = TF.detect_and_describe(T(img), port_config(cfg))
    return jk, np.asarray(jd), tk, td.numpy(), img, cfg


def test_shared_sampling_frontend_matches_jax(shared_frontends):
    """The whole frontend with ``sampling="shared"`` (bf16 gradients, the
    default): >= 95% of the JAX keypoints have a port keypoint within 0.05
    px at the same scale; matched keypoints with the same angle (1e-3) have
    descriptors within 2e-2 on the unit-norm scale (the bound of the rotated
    path's test above: bf16 storage of f32 values from two blurs)."""
    jk, jd, tk, td, _, _ = shared_frontends
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert jm.sum() == 256 and tm.sum() == 256
    jxy, txy = np.asarray(jk.xy), tk.xy.numpy()
    ja, ta = np.asarray(jk.angle), tk.angle.numpy()
    found, pairs = 0, 0
    for i in np.where(jm)[0]:
        near = (np.linalg.norm(txy - jxy[i], axis=1) < 0.05) & tm
        found += bool(near.any())
        cand = np.where(near & (np.abs(np.angle(np.exp(1j * (ta - ja[i])))) < 1e-3))[0]
        if cand.size:
            pairs += 1
            assert np.abs(td[cand[0]] - jd[i]).max() / 512.0 <= 2e-2
    assert found >= 0.95 * 256 and pairs >= 0.95 * 256


def test_shared_sampling_lanes_equal_single_images(shared_frontends):
    """The lane axis with ``sampling="shared"``: a stack of the frame and
    its mirror gives, lane by lane, each image's own detection bit for bit
    (valid keypoints and all descriptors)."""
    _, _, _, _, img, cfg = shared_frontends
    stack = np.stack([img, np.ascontiguousarray(img[:, ::-1])])
    kl, dl = TF.detect_and_describe(T(stack), port_config(cfg))
    for b in range(2):
        k1, d1 = TF.detect_and_describe(T(stack[b]), port_config(cfg))
        m = k1.mask
        assert torch.equal(kl.mask[b], m) and int(m.sum()) > 200
        for a, c in zip(kl, k1):
            assert torch.equal(a[b][m], c[m])
        assert torch.equal(dl[b], d1)
