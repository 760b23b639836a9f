"""The port's command line (``python -m structure_from_motion_tpu_torch``):
the parser against the JAX package's flag for flag, ``selftest`` and a small
``reconstruct`` on the CPU with every export and a resume, and the exits of
the flags whose code is not ported yet."""

import argparse
import json
import os

import numpy as np
import pytest

from structure_from_motion_tpu import __main__ as Jmain
from structure_from_motion_tpu_torch import __main__ as Tmain
from structure_from_motion_tpu_torch.io.colmap import read_colmap_text
from structure_from_motion_tpu_torch.io.ply import read_ply
from structure_from_motion_tpu_torch.io.synthetic import synthetic_scene_sequence
from structure_from_motion_tpu_torch.io.tum import load_tum_trajectory
from tests.test_torch_io import write_bmp

# the three flags that differ by design: the devices are another backend's,
# and the compile cache is accepted but has nothing to cache
DIFFERENT = {"--device", "--compile-cache"}


def test_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as e:
        Tmain.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "reconstruct" in out and "selftest" in out


def test_subcommand_required():
    with pytest.raises(SystemExit) as e:
        Tmain.main([])
    assert e.value.code == 2


def test_reconstruct_requires_intrinsics(capsys):
    with pytest.raises(SystemExit) as e:
        Tmain.main(["reconstruct", "--images", "/tmp/x", "--out", "/tmp/y"])
    assert e.value.code == 2
    assert "--fx" in capsys.readouterr().err


def _jax_parser(monkeypatch):
    """The JAX package builds its parser inside ``main``: catch it at
    ``parse_args``."""
    caught = {}

    def grab(self, argv=None):
        caught["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        Jmain.main([])
    monkeypatch.undo()
    return caught["parser"]


def _subcommands(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _flags(parser):
    return {a.option_strings[0]: a for a in parser._actions
            if a.option_strings and a.option_strings[0] != "-h"}


def test_every_flag_of_the_jax_parser_exists_with_the_same_default(monkeypatch):
    jax_cmds, port_cmds = _subcommands(_jax_parser(monkeypatch)), _subcommands(
        Tmain.build_parser())
    assert set(port_cmds) == set(jax_cmds) == {"reconstruct", "selftest"}
    compared = 0
    for cmd in jax_cmds:
        jf, tf = _flags(jax_cmds[cmd]), _flags(port_cmds[cmd])
        assert set(tf) == set(jf), cmd
        for name, ja in jf.items():
            ta = tf[name]
            assert type(ta) is type(ja) and ta.required == ja.required, name
            assert ta.dest == ja.dest and ta.nargs == ja.nargs and ta.type == ja.type, name
            if name in DIFFERENT:
                continue
            assert ta.default == ja.default and ta.choices == ja.choices, name
            compared += 1
    assert compared >= 24
    rec, st = _flags(port_cmds["reconstruct"]), _flags(port_cmds["selftest"])
    assert rec["--device"].default == st["--device"].default == "cuda"
    assert rec["--device"].choices == st["--device"].choices == ["cuda", "cpu"]
    assert rec["--compile-cache"].default is None


def test_default_flags_build_the_default_reconstruct_config(monkeypatch):
    """The config the port builds from its default flags is the JAX
    package's, field for field."""
    import dataclasses

    from tests.test_torch_config import port_config

    argv = ["reconstruct", "--images", "x", "--out", "y", "--fx", "1", "--fy", "1", "--cx", "0",
            "--cy", "0"]
    for extra in ([], ["--no-upsample", "--max-kp", "256", "--no-gate", "--window-mode", "stop"],
                  ["--dist", "-0.2", "0.05", "--keyframe-min-flow", "2.5", "--max-views", "8"]):
        targs = Tmain.build_parser().parse_args(argv + extra)
        jargs = argparse.Namespace(**{**vars(targs), "device": ""})
        got, want = Tmain._build_config(targs), Jmain._build_config(jargs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got == port_config(want)


def test_selftest_passes_on_the_cpu(capsys):
    assert Tmain.main(["selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selftest ATE=" in out and out.strip().endswith("PASS")


def test_entry_points_raise_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        Tmain.main(["selftest"])


@pytest.mark.parametrize("flags, item", [(["--detector", "harris"], "ROADMAP A12"),
                                         (["--ba-shards", "2"], "ROADMAP A13")])
def test_flags_of_later_slices_exit_with_the_roadmap_item(tmp_path, capsys, flags, item):
    rc = Tmain.main(["reconstruct", "--images", str(tmp_path), "--out", str(tmp_path / "o"),
                     "--fx", "1", "--fy", "1", "--cx", "0", "--cy", "0", "--device", "cpu",
                     *flags])
    assert rc != 0 and item in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


@pytest.fixture(scope="module")
def bmp_frames(tmp_path_factory):
    """6 rendered 120x160 frames as 24-bit BMP files: 4 in one directory,
    all 6 in another (the resume's input)."""
    imgs, K, C_gt, _ = synthetic_scene_sequence(6, (120, 160), seed=3, loops=0.42)
    root = tmp_path_factory.mktemp("frames")
    for name, n in (("first4", 4), ("all6", 6)):
        os.makedirs(root / name)
        for i in range(n):
            g = np.clip(np.asarray(imgs[i]), 0, 255).astype(np.uint8)
            write_bmp(str(root / name / f"frame{i:03d}.bmp"), np.stack([g, g, g], -1))
    return root, K, C_gt


def _reconstruct(images, out, K, *extra):
    return Tmain.main([
        "reconstruct", "--images", str(images), "--pattern", "*.bmp", "--out", str(out),
        "--fx", str(K[0, 0]), "--fy", str(K[1, 1]), "--cx", str(K[0, 2]), "--cy", str(K[1, 2]),
        "--device", "cpu", "--max-kp", "256", "--no-upsample", *extra])


def test_reconstruct_on_the_cpu_writes_everything_and_resumes(bmp_frames, tmp_path, capsys):
    root, K, _ = bmp_frames
    out = tmp_path / "out"
    rc = _reconstruct(root / "first4", out, K, "--export-tum", "--export-ply",
                      "--export-colmap", "--checkpoint-every", "2", "--compile-cache", "unused")
    captured = capsys.readouterr()
    assert rc == 0 and "--compile-cache is ignored" in captured.err
    assert "4 frames in" in captured.out and "frames/s" in captured.out
    for name in ("config.json", "state.npz", "reconstruction.npz", "trajectory.tum",
                 "reconstruction.ply", "colmap/cameras.txt", "colmap/images.txt",
                 "colmap/points3D.txt"):
        assert (out / name).exists(), name
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["frontend"]["max_keypoints"] == 256 and cfg["window_mode"] == "slide"
    rec = np.load(out / "reconstruction.npz")
    locs, rots, pts = rec["locations"], rec["rotations"], rec["points"]
    assert locs.shape == (4, 3) and rots.shape == (4, 3, 3) and np.isfinite(locs).all()
    ts, tum_C, tum_R = load_tum_trajectory(str(out / "trajectory.tum"))
    np.testing.assert_array_equal(ts, [0, 1, 2, 3])
    np.testing.assert_allclose(tum_C, locs, atol=1e-6)
    np.testing.assert_allclose(tum_R, rots, atol=1e-5)
    xyz, _ = read_ply(str(out / "reconstruction.ply"))
    assert len(xyz) == len(pts) + 4
    np.testing.assert_allclose(xyz[len(pts):], locs, atol=1e-5)
    model = read_colmap_text(str(out / "colmap"))
    np.testing.assert_allclose(model["locs"], locs, atol=1e-6)
    assert model["names"] == [f"frame{i:03d}.bmp" for i in range(4)]
    assert len(model["points"]) == len(pts)

    # the resume picks up at the next unseen input
    rc = _reconstruct(root / "all6", out, K, "--resume", "--export-tum")
    text = capsys.readouterr().out
    assert rc == 0 and "resumed at frame 4 (input file 4)" in text
    assert "frame004.bmp" in text and "frame003.bmp:" not in text
    rec2 = np.load(out / "reconstruction.npz")
    assert rec2["locations"].shape == (6, 3)
    np.testing.assert_array_equal(load_tum_trajectory(str(out / "trajectory.tum"))[0],
                                  np.arange(6))


def test_reconstruct_through_the_feature_cache_gives_the_same_poses(bmp_frames, tmp_path,
                                                                     capsys):
    """``--cache-features`` goes through ``IncrementalSfM.detect`` and
    ``process_features``; a second run reads the cache and skips detection;
    both give the poses of the direct run."""
    root, K, _ = bmp_frames
    runs = []
    for out, extra in (("direct", []), ("cached", ["--cache-features"]),
                       ("cached", ["--cache-features"])):
        assert _reconstruct(root / "first4", tmp_path / out, K, *extra) == 0
        runs.append(np.load(tmp_path / out / "reconstruction.npz")["locations"])
    capsys.readouterr()
    assert len(os.listdir(tmp_path / "cached" / "features")) == 4
    np.testing.assert_array_equal(runs[1], runs[0])
    np.testing.assert_array_equal(runs[2], runs[0])


def test_reconstruct_without_images_exits_2(tmp_path, capsys):
    assert _reconstruct(tmp_path, tmp_path / "o", np.eye(3)) == 2
    assert "no images match" in capsys.readouterr().err
