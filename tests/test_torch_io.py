"""Host-side ingest and export of the PyTorch port, held against the JAX
package on the same numpy inputs: BMP decode (exact), the prefetcher's
order and error position, TUM / PLY / COLMAP files (equal bytes), feature
caches (load in both packages) and the reprojection statistics (1e-5: f32
residuals summed by two libraries)."""

import struct

import jax
import numpy as np
import pytest
import torch

from structure_from_motion_tpu.config import CapacityConfig
from structure_from_motion_tpu.io import colmap as Jcolmap
from structure_from_motion_tpu.io import datasets as Jdata
from structure_from_motion_tpu.io import ply as Jply
from structure_from_motion_tpu.io import tum as Jtum
from structure_from_motion_tpu.models import tracks as Jtracks
from structure_from_motion_tpu.utils import checkpoint as Jckpt
from structure_from_motion_tpu.utils import metrics as Jmetrics
from structure_from_motion_tpu_torch.convert import state_from_numpy
from structure_from_motion_tpu_torch.io import colmap as Tcolmap
from structure_from_motion_tpu_torch.io import datasets as Tdata
from structure_from_motion_tpu_torch.io import ply as Tply
from structure_from_motion_tpu_torch.io import tum as Ttum
from structure_from_motion_tpu_torch.io.prefetch import DevicePrefetcher
from structure_from_motion_tpu_torch.utils import checkpoint as Tckpt
from structure_from_motion_tpu_torch.utils import metrics as Tmetrics


def write_bmp(path, rgb, bpp=24, top_down=False):
    """Uncompressed 24/32-bit BMP of an (H, W, 3) uint8 RGB array."""
    h, w, _ = rgb.shape
    ch = bpp // 8
    stride = (w * ch + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    px = np.full((h, w, ch), 255, np.uint8)
    px[..., :3] = rgb[..., ::-1]  # BGR
    rows[:, : w * ch] = px.reshape(h, w * ch)
    if not top_down:
        rows = rows[::-1]
    header = b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + struct.pack(
        "<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, 0, rows.size, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + rows.tobytes())


@pytest.mark.parametrize("bpp, top_down, size", [(24, False, (13, 21)), (32, False, (8, 10)),
                                                 (24, True, (9, 16))])
def test_bmp_decode_equals_the_jax_packages(tmp_path, bpp, top_down, size):
    rng = np.random.default_rng(bpp + size[0])
    rgb = rng.integers(0, 256, size=(*size, 3), dtype=np.uint8)
    path = str(tmp_path / "frame.bmp")
    write_bmp(path, rgb, bpp, top_down)
    got, want = Tdata.load_image_grayscale(path), Jdata.load_image_grayscale(path)
    assert got.dtype == np.float32 and got.shape == size
    np.testing.assert_array_equal(got, want)
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    np.testing.assert_allclose(got, luma, atol=1e-3)
    with pytest.raises(ValueError, match="not a BMP"):
        (tmp_path / "x.bmp").write_bytes(b"PNG....")
        Tdata._decode_bmp_grayscale(str(tmp_path / "x.bmp"))


def test_points_txt_and_intrinsics_equal_the_jax_packages(tmp_path):
    path = tmp_path / "pts.txt"
    path.write_text("3\n10.5 20.25\n1 2 3\n7 8\n")
    np.testing.assert_array_equal(Tdata.load_points_txt(str(path)),
                                  Jdata.load_points_txt(str(path)))
    np.testing.assert_array_equal(Tdata.upenn_intrinsics(), Jdata.upenn_intrinsics())


def test_prefetcher_on_cpu_yields_the_sequential_frames_in_order():
    frames = {f"f{i}": np.full((4, 6), i, np.float32) for i in range(7)}
    got = list(DevicePrefetcher(list(frames), frames.__getitem__, depth=2, device="cpu"))
    assert [p for p, _ in got] == list(frames)
    for p, t in got:
        assert torch.is_tensor(t) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), frames[p])


def test_prefetcher_reraises_a_loaders_exception_at_its_position():
    def loader(p):
        if p == 3:
            raise OSError("frame 3 is unreadable")
        return np.zeros((2, 2), np.float32) + p

    seen = []
    with pytest.raises(OSError, match="frame 3"):
        for p, t in DevicePrefetcher(range(6), loader, device="cpu"):
            seen.append((p, float(t[0, 0])))
    assert seen == [(0, 0.0), (1, 1.0), (2, 2.0)]


def test_prefetcher_worker_ends_when_the_consumer_stops_early():
    """A consumer that leaves the loop (here: an exception in its own work)
    must not leave the worker blocked on a full queue."""
    loaded = []

    def loader(p):
        loaded.append(p)
        return np.zeros((2, 2), np.float32)

    pre = DevicePrefetcher(range(50), loader, depth=2, device="cpu")
    with pytest.raises(RuntimeError, match="consumer"):
        for p, _ in pre:
            if p == 1:
                raise RuntimeError("the consumer failed")
    pre.close()  # a second close is harmless
    assert not pre._thread.is_alive() and pre._q.empty()
    assert len(loaded) < 10
    with DevicePrefetcher(range(50), loader, depth=1, device="cpu") as pre:
        assert next(iter(pre))[0] == 0
    assert not pre._thread.is_alive()


def test_prefetcher_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher([], lambda p: p)


def _poses(rng, n, spread=None):
    """Random cam-to-world poses; with ``spread`` the cameras stay near the
    origin and nearly parallel (all see a scene in front of them)."""
    q = rng.normal(size=(n, 4))
    if spread is not None:
        q = np.array([1.0, 0, 0, 0]) + spread * q
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)
    return rng.normal(size=(n, 3)) * (3.0 if spread is None else 10.0 * spread), R


def _state_arrays(rng, locs, rots, K, n_live):
    """A small filled track store as numpy arrays (the last ``n_live`` poses
    are the live slots): points in front of the cameras, each seen by a few
    live views with half a pixel of noise."""
    cap = CapacityConfig(max_views=6, max_keypoints=32, max_points=64, max_observations=256)
    d = {k: np.array(v) for k, v in jax.device_get(
        Jtracks.init_state(cap, np.asarray(K, np.float32), desc_dim=8))._asdict().items()}
    F = len(locs)
    d["cam_valid"][:n_live] = True
    d["cam_C"][:n_live] = locs[F - n_live:]
    from structure_from_motion_tpu_torch.utils.rotations import rotation_to_quat

    d["cam_q"][:n_live] = rotation_to_quat(torch.as_tensor(rots[F - n_live:])).numpy()
    n_pts, o = 40, 0
    for p in range(n_pts):
        cam = int(rng.integers(0, n_live))
        X = locs[F - n_live + cam] + rots[F - n_live + cam] @ np.array(
            [rng.normal(), rng.normal(), 6.0 + rng.random()])
        d["points"][p], d["pt_valid"][p] = X, True
        for v in rng.choice(n_live, size=3, replace=False):
            Xc = rots[F - n_live + v].T @ (X - locs[F - n_live + v])
            uv = (K @ (Xc / Xc[2]))[:2] + rng.normal(size=2) * 0.5
            d["obs_cam"][o], d["obs_pt"][o], d["obs_uv"][o], d["obs_valid"][o] = v, p, uv, True
            o += 1
    d["num_points"], d["num_obs"] = np.int32(n_pts), np.int32(o)
    return d


def test_tum_files_equal_the_jax_packages_and_read_back(tmp_path):
    locs, rots = _poses(np.random.default_rng(0), 9)
    ts = np.arange(9, dtype=np.float64) * 3.0
    a, b = str(tmp_path / "port.tum"), str(tmp_path / "jax.tum")
    assert Ttum.export_tum_trajectory(a, locs, rots, timestamps=ts) == 9
    Jtum.export_tum_trajectory(b, locs, rots, timestamps=ts)
    assert open(a, "rb").read() == open(b, "rb").read()
    got_ts, got_C, got_R = Ttum.load_tum_trajectory(a)
    want = Jtum.load_tum_trajectory(b)
    for g, w in zip((got_ts, got_C, got_R), want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-12)
    np.testing.assert_allclose(got_C, locs, atol=1e-8)  # 9 decimals in the file
    np.testing.assert_allclose(got_R, rots, atol=1e-8)
    with pytest.raises(ValueError, match="bad trajectory shapes"):
        Ttum.export_tum_trajectory(a, locs[:, :2], rots)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_files_equal_the_jax_packages_and_read_back(tmp_path, binary):
    rng = np.random.default_rng(1)
    pts, cams = rng.normal(size=(50, 3)), rng.normal(size=(4, 3))
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    assert Tply.export_ply(a, pts, cameras=cams, binary=binary) == 54
    Jply.export_ply(b, pts, cameras=cams, binary=binary)
    assert open(a, "rb").read() == open(b, "rb").read()
    xyz, rgb = Tply.read_ply(a)
    np.testing.assert_allclose(xyz, np.concatenate([pts, cams]), atol=1e-6)
    assert (rgb[:50] == 220).all() and tuple(rgb[-1]) == (255, 40, 40)


@pytest.mark.parametrize("per_view_K", [False, True])
def test_colmap_files_equal_the_jax_packages_and_read_back(tmp_path, per_view_K):
    rng = np.random.default_rng(2)
    locs, rots = _poses(rng, 7, spread=0.05)  # 3 archived poses + 4 live slots
    K = np.array([[500.0, 0, 320.0], [0, 510.0, 240.0], [0, 0, 1.0]])
    d = _state_arrays(rng, locs, rots, K, n_live=4)
    if per_view_K:
        d["K"][2, 0, 0] = 640.0
    names = [f"img{i:03d}.bmp" for i in range(7)]
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    got = Tcolmap.export_colmap_text(a, locs, rots, d["K"], (640, 480), image_names=names,
                                     state=state_from_numpy(d, "cpu"))
    want = Jcolmap.export_colmap_text(b, locs, rots, d["K"], (640, 480), image_names=names,
                                      state=Jtracks.SfMState(**d))
    assert got == want and got["points"] == 40 and got["observations"] == 120
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert open(f"{a}/{name}").read() == open(f"{b}/{name}").read(), name
    back, jback = Tcolmap.read_colmap_text(a), Jcolmap.read_colmap_text(b)
    np.testing.assert_allclose(back["locs"], locs, atol=1e-9)
    np.testing.assert_allclose(back["rots"], rots, atol=1e-9)
    for key in ("locs", "rots", "K", "Ks", "points", "point_ids"):
        np.testing.assert_allclose(back[key], np.asarray(jback[key]), atol=1e-12)
    assert back["names"] == names and back["tracks"] == jback["tracks"]
    assert (len({tuple(k.ravel()) for k in back["Ks"]}) > 1) == per_view_K


def test_feature_caches_load_in_both_packages(tmp_path):
    rng = np.random.default_rng(3)
    xy = rng.random((16, 2)).astype(np.float32)
    desc = rng.normal(size=(16, 128)).astype(np.float32)
    valid = rng.random(16) < 0.7
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    Tckpt.save_features_cache(a, torch.as_tensor(xy), torch.as_tensor(desc),
                              torch.as_tensor(valid))
    Jckpt.save_features_cache(b, xy, desc, valid)
    for load in (Tckpt.load_features_cache, Jckpt.load_features_cache):
        for path in (a, b):
            for got, want in zip(load(path), (xy, desc, valid)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_reprojection_stats_and_ate_equal_the_jax_packages():
    rng = np.random.default_rng(4)
    locs, rots = _poses(rng, 5, spread=0.05)
    # a 64x48 image: 1e-5 is a few f32 ulps of a coordinate below 64 px (at
    # 640 px one ulp alone is 6e-5)
    K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]])
    d = _state_arrays(rng, locs, rots, K, n_live=5)
    got = Tmetrics.reprojection_stats(state_from_numpy(d, "cpu"))
    # XLA's CPU backend may take an f32 einsum at reduced precision by
    # default; the comparison is at full f32
    with jax.default_matmul_precision("highest"):
        want = Jmetrics.reprojection_stats(Jtracks.SfMState(**d))
    assert got.keys() == want.keys() and got["count"] == want["count"] == 120
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k
    assert 0.2 < got["mean_px"] < 1.5  # half a pixel of noise on each axis
    d["obs_valid"][:] = False
    assert Tmetrics.reprojection_stats(state_from_numpy(d, "cpu")) == {"count": 0}
    est = locs * 2.5 + np.array([1.0, -2.0, 0.5]) + rng.normal(size=locs.shape) * 0.01
    assert Tmetrics.absolute_trajectory_error(est, locs) == pytest.approx(
        Jmetrics.absolute_trajectory_error(est, locs), abs=1e-12)
    for g, w in zip(Tmetrics.umeyama_alignment(est, locs), Jmetrics.umeyama_alignment(est, locs)):
        np.testing.assert_allclose(g, w, atol=1e-12)


# -- the native loader (ctypes over native/sfm_loader.cpp) ----------------------


@pytest.fixture
def native(monkeypatch):
    """The port's native loader, built here from ``native/sfm_loader.cpp``
    into ``build/native/`` (skips only when ``make`` fails), and the JAX
    package's bindings pointed at that same library (its own build would
    write into ``native/``)."""
    from structure_from_motion_tpu.io import native_loader as Jnl
    from structure_from_motion_tpu_torch.io import native_loader as Tnl

    if not Tnl.native_available():
        pytest.skip("the native loader did not build here (make failed)")
    monkeypatch.setattr(Jnl, "_LIB_PATH", str(Tnl._LIB_PATH))
    monkeypatch.setattr(Jnl, "_lib", None)
    monkeypatch.setattr(Jnl, "_build_failed", False)
    assert Jnl.native_available()
    return Jnl, Tnl


@pytest.mark.parametrize("bpp, top_down, size", [(24, False, (13, 21)), (32, False, (8, 10)),
                                                 (24, True, (9, 16))])
def test_native_decode_equals_the_jax_packages(tmp_path, native, bpp, top_down, size):
    """BMP files decode natively to the JAX package's native decode bit for
    bit, and to the Python decoder within 1e-3 (the JAX test's bound: the
    C++ luma sums in another order)."""
    Jnl, Tnl = native
    rng = np.random.default_rng(bpp + size[1])
    path = str(tmp_path / "frame.bmp")
    write_bmp(path, rng.integers(0, 256, size=(*size, 3), dtype=np.uint8), bpp, top_down)
    got = Tnl.decode_grayscale(path)
    assert got is not None and got.dtype == np.float32 and got.shape == size
    np.testing.assert_array_equal(got, Jnl.decode_grayscale(path))
    np.testing.assert_allclose(got, Tdata.load_image_grayscale(path), atol=1e-3)
    assert Tnl.decode_grayscale(str(tmp_path / "missing.bmp")) is None


def test_prefetching_loader_order_and_fallback(tmp_path, native):
    """The port's PrefetchingLoader against the JAX package's on the same
    files: in order, out of order, and a file the library does not decode
    (a PNG) through each package's Python decoder; all equal."""
    from PIL import Image

    Jnl, Tnl = native
    rng = np.random.default_rng(4)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"f{i}.bmp"))
        write_bmp(paths[-1], rng.integers(0, 256, size=(12, 20, 3), dtype=np.uint8))
    paths.append(str(tmp_path / "x.png"))
    Image.fromarray(rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)).save(paths[-1])
    with Tnl.PrefetchingLoader(paths, n_threads=2) as ld:
        got = list(ld)
        again = [ld.get(i) for i in (3, 1, 0, 2)]
    jl = Jnl.PrefetchingLoader(paths, n_threads=2)
    want = list(jl)
    jl.close()
    assert len(got) == 4 and got[3].shape == (8, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i, a in zip((3, 1, 0, 2), again):
        np.testing.assert_array_equal(a, got[i])
    np.testing.assert_array_equal(got[3], Tdata.load_image_grayscale(paths[3]))
