"""The live engine's host contract (the JAX package's: one grouped metric
fetch a frame, eviction records copied to the host asynchronously and read
lazily, the frame's stretch from the image to the recorded matches one
program): the grouped fetch against per-key ``.cpu().numpy()``, the lazy
eviction archive against eager records through a checkpoint save and
``finalize_global``, ``utils/control.graphed`` running eagerly on the CPU,
the cached device constants, and the synchronisation inventory's site
attribution (``tools/slice_frames.py``)."""

import copy
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from structure_from_motion_tpu_torch import device as D
from structure_from_motion_tpu_torch.models import incremental, tracks
from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM
from structure_from_motion_tpu_torch.utils import checkpoint, control
from tests.test_incremental import pipeline_config, synthetic_sequence  # noqa: F401
from tests.test_torch_config import port_config


def _per_key(info: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in info.items()}


def _same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_grouped_fetch_equals_per_key():
    """Keys, dtypes, shapes and values of one grouped copy equal those of a
    copy a key, for every dtype and shape a frame's statistics have (0-dim,
    empty, bool, int32, int64, float32)."""
    g = torch.Generator().manual_seed(0)
    info = {
        "matches": torch.randint(0, 99, (), generator=g, dtype=torch.int32),
        "ba_costs": torch.rand(5, generator=g),
        "cheirality_counts": torch.randint(0, 9, (4,), generator=g, dtype=torch.int32),
        "reprojection_px": torch.rand((), generator=g),
        "ids": torch.randint(0, 9, (2, 3), generator=g, dtype=torch.int64),
        "flags": torch.rand(7, generator=g) < 0.5,
        "empty": torch.zeros((0, 3)),
        "lanes": torch.rand(8, 3, generator=g)[:, 1],  # a strided view
    }
    _same(D.fetch(info), _per_key(info))
    assert D.fetch({}) == {}


@pytest.fixture(scope="module")
def slide_run(pipeline_config):  # noqa: F811
    """A 7-frame, window-4 slide run with precomputed features on the CPU,
    with every eviction record also taken eagerly and every frame's
    statistics also fetched a key at a time."""
    K, frames, _, _, _ = synthetic_sequence(n_views=7, n_points=200, seed=2, noise=0.4)
    cfg = port_config(dataclasses.replace(pipeline_config, window_size=4, window_mode="slide"))
    eng = IncrementalSfM(cfg, K, frontend="precomputed", device="cpu")
    eager, infos = [], []
    append_device, fetch = tracks.EvictionArchive.append_device, incremental.fetch

    def spy_append(self, rec):
        eager.append(tracks.EvictionRecord(*(a.cpu().numpy().copy() for a in rec)))
        append_device(self, rec)

    def spy_fetch(tensors):
        got = fetch(tensors)
        infos.append((got, _per_key(tensors)))
        return got

    tracks.EvictionArchive.append_device = spy_append
    incremental.fetch = spy_fetch
    try:
        for f in frames:
            eng.process_features(*f)
    finally:
        tracks.EvictionArchive.append_device = append_device
        incremental.fetch = fetch
    return dict(engine=eng, eager=eager, infos=infos, cfg=cfg, K=K)


def test_engine_metrics_fetch_equals_per_key(slide_run):
    """Every frame's statistics, fetched in one grouped copy, equal the copy
    a key of the same tensors."""
    assert len(slide_run["infos"]) == 7
    for got, want in slide_run["infos"]:
        _same(got, want)


def test_lazy_archive_equals_eager_records(slide_run, tmp_path):
    """The lazy archive holds the eager records, field for field and bit
    for bit; a checkpoint saved from it holds the same arrays as one saved
    from the eager records; ``finalize_global`` gives the same poses and
    costs from either."""
    eng, eager = slide_run["engine"], slide_run["eager"]
    assert len(eng._archive) == len(eager) == 3
    for got, want in zip(eng._archive, eager):
        for f in tracks.EvictionRecord._fields:
            a, b = np.asarray(getattr(got, f)), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert [r.C.tolist() for r in eng._archive[1:]] == [r.C.tolist() for r in eager[1:]]

    lazy_path, eager_path = str(tmp_path / "lazy.npz"), str(tmp_path / "eager.npz")
    eng.save_checkpoint(lazy_path)
    checkpoint.save_state(eager_path, eng.state, eng._frame, archive=eager,
                          keyframes=(eng.keyframe_indices, eng._input_index))
    with np.load(lazy_path) as a, np.load(eager_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    other = copy.deepcopy(eng)
    other._archive = tracks.EvictionArchive(eager)
    got, want = eng.finalize_global(iterations=2), other.finalize_global(iterations=2)
    np.testing.assert_array_equal(np.asarray(got["costs"]), np.asarray(want["costs"]))
    for a, b in zip(eng.poses(), other.poses()):
        np.testing.assert_array_equal(a, b)


def test_archive_reads_each_record_once():
    """A record appended as tensors stays a pending copy until it is read,
    then is the numpy record; indexing, slicing, iteration and ``len``
    read it as a list of records does."""
    rec = tracks.EvictionRecord(*(torch.arange(n).to(dt) % 2 for n, dt in (
        (3, torch.float32), (4, torch.float32), (9, torch.float32), (5, torch.int32),
        (10, torch.float32), (15, torch.float32), (5, torch.bool))))
    arc = tracks.EvictionArchive([tracks.EvictionRecord(*(t.numpy() for t in rec))])
    arc.append_device(rec)
    assert isinstance(arc._items[1], D.HostCopy)
    assert len(arc) == 2 and all(isinstance(r, tracks.EvictionRecord) for r in arc)
    assert not isinstance(arc._items[1], D.HostCopy)
    for a, b in zip(arc[-1], arc[0]):
        np.testing.assert_array_equal(a, b)
    assert len(arc[1:]) == 1 and arc[:1][0] is arc[0]


def test_graphed_runs_eagerly_on_the_cpu():
    """``control.graphed`` on CPU tensors is the call it wraps: the same
    results, an unchanged input returned as itself, no capture."""
    control.reset_stats()

    def fn(x, n, pair):
        return {"y": x * n + pair[0], "same": pair[1]}

    x, a, b = torch.arange(6.0), torch.ones(6), torch.zeros(2)
    for _ in range(3):
        out = control.graphed(fn, x, 3, (a, b))
        assert torch.equal(out["y"], x * 3 + a) and out["same"] is b
    assert control.stats.call_captures == control.stats.call_replays == 0


def test_front_stage_is_the_front_on_the_cpu(slide_run):
    """The front stage (drawn F-gate uniforms, the slot as a device tensor,
    through ``graphed``) gives the state that ``_front`` gives with the
    slot as a Python int and the generators drawing inside, bit for bit."""
    eng, cfg = slide_run["engine"], slide_run["cfg"]
    rng = np.random.default_rng(5)
    Kk = cfg.capacity.max_keypoints
    xy = torch.as_tensor(rng.uniform(0, 400, (1, Kk, 2)).astype(np.float32))
    D_ = cfg.frontend.descriptor_dim
    desc = torch.as_tensor(rng.normal(size=(1, Kk, D_)).astype(np.float32))
    valid = torch.as_tensor(rng.random((1, Kk)) < 0.9)
    st = tracks.lanes_of(eng.state)
    v = 3
    draws = incremental.LazyDraws([0], 9, "cpu")
    got = incremental._front_stage(st, v, draws, (xy, desc, valid), cfg)
    want = incremental._front(st, v, draws.gate_source(), (xy, desc, valid), config=cfg)
    for f, a, b in zip(tracks.SfMState._fields, got, want):
        assert torch.equal(a, b), f


def test_device_constants_are_uploaded_once():
    """A constant table is made once a device and shared after; while
    ``torch.export`` traces, each call makes its own."""
    a = D.constant([[1, 2], [3, 4]], torch.long, "cpu")
    assert D.constant([[1, 2], [3, 4]], torch.long, "cpu") is a
    assert torch.equal(a, torch.tensor([[1, 2], [3, 4]]))
    assert D.constant([1.5, 2.0], torch.float32, "cpu") is not a

    class M(torch.nn.Module):
        def forward(self, x):
            return x + D.constant([1.0, 2.0], torch.float32, x.device)

    ep = torch.export.export(M(), (torch.zeros(2),), strict=False)
    assert torch.equal(ep.module()(torch.ones(2)), torch.tensor([2.0, 3.0]))


def test_sync_sites_name_the_package_frame(monkeypatch):
    """The inventory's site of a synchronisation is the innermost frame of
    the package (outside ``tools/``); a report torch logs to standard error
    (a boxed operator's) counts under ``logged:``."""
    from structure_from_motion_tpu_torch.tools import slice_frames

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    real = torch.linalg.svd

    def warned(*args, **kwargs):
        warnings.warn("called a synchronizing CUDA operation")
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.linalg, "svd", warned)
    with slice_frames.host_syncs() as sites:
        torch.ops.sfm.small_svd(torch.eye(3)[None], True)
        os.write(2, b"[W] Warning: called a synchronizing CUDA operation (function item)\n")
    assert sites["logged: item"] == 1
    (site,) = [k for k in sites if k.startswith("ops/small_svd.py:")]
    assert site.split()[1] == "small_svd_reference" and sites[site] == 1
