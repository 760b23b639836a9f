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

T = torch.from_numpy


@pytest.fixture(scope="module")
def frontends():
    imgs, *_ = synthetic_scene_sequence(n_frames=1, size=(256, 384), seed=3, loops=0.21)
    img = imgs[0].astype(np.float32)
    cfg = FrontendConfig(max_keypoints=256, num_octaves=2, blur_impl="pallas",
                         extrema_impl="pallas", extrema_dtype="f32")
    jk, jd = jax.device_get(JF.detect_and_describe(jnp.asarray(img), cfg))
    tk, td = TF.detect_and_describe(T(img), cfg)
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
