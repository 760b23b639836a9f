"""The port stands on its own: its configuration tree and rendered scene
are copies that agree with the JAX package's, and nothing under
``structure_from_motion_tpu_torch/`` or in ``chip_smoke.py`` imports JAX or
the JAX package."""

import dataclasses
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import structure_from_motion_tpu.config as Jcfg
import structure_from_motion_tpu_torch.config as Tcfg
from structure_from_motion_tpu.io import synthetic as Jsyn
from structure_from_motion_tpu_torch.io import synthetic as Tsyn

ROOT = Path(__file__).resolve().parents[1]
CLASSES = ["RansacConfig", "LMConfig", "FrontendConfig", "MatcherConfig", "BAConfig",
           "CapacityConfig", "PipelineConfig"]


def port_config(cfg):
    """The port's counterpart of a JAX-package config object, field by
    field (nested dataclasses by class name)."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    klass = getattr(Tcfg, type(cfg).__name__)
    return klass(**{f.name: port_config(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})


def _default(field):
    if field.default is not dataclasses.MISSING:
        return field.default
    return dataclasses.asdict(field.default_factory())


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_types_and_defaults_match(name):
    jf = dataclasses.fields(getattr(Jcfg, name))
    tf = dataclasses.fields(getattr(Tcfg, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert a.type == b.type, a.name
        assert _default(a) == _default(b), a.name
    assert dataclasses.asdict(getattr(Tcfg, name)()) == dataclasses.asdict(getattr(Jcfg, name)())


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


@pytest.mark.parametrize("which", ["cli_default_config", "long_sequence_config"])
def test_config_json_round_trip_between_packages(which):
    port = getattr(_chip_smoke(), which)()
    assert type(port) is Tcfg.PipelineConfig
    jax_cfg = Jcfg.PipelineConfig.from_json(port.to_json())
    assert dataclasses.asdict(jax_cfg) == dataclasses.asdict(port)
    back = Tcfg.PipelineConfig.from_json(jax_cfg.to_json())
    assert back == port
    assert port_config(jax_cfg) == port
    assert back.matcher.gate_ransac.num_hypotheses == jax_cfg.matcher.gate_ransac.num_hypotheses


def test_config_json_keeps_tiers_and_ignores_unknown_keys():
    cfg = Tcfg.PipelineConfig(ba=Tcfg.BAConfig(obs_layout="tiered", tiers=((4, 8), (16, 2))),
                              distortion=(0.1, 0.01, 0.0, 0.0))
    text = cfg.to_json().replace('"window_size"', '"from_a_later_version": 1, "window_size"', 1)
    got, want = Tcfg.PipelineConfig.from_json(text), Jcfg.PipelineConfig.from_json(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.distortion == cfg.distortion and isinstance(got.ba.tiers, tuple)
    assert [tuple(t) for t in got.ba.tiers] == [(4, 8), (16, 2)]


@pytest.mark.parametrize("kwargs", [
    dict(n_frames=3, size=(48, 64), seed=3, loops=0.21),
    dict(n_frames=2, size=(60, 80), seed=11, path_scale=0.5),
])
def test_synthetic_scene_equals_the_jax_packages(kwargs):
    got, want = Tsyn.synthetic_scene_sequence(**kwargs), Jsyn.synthetic_scene_sequence(**kwargs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pose_kwargs = {k: v for k, v in kwargs.items() if k != "seed"}
    for a, b in zip(Tsyn.synthetic_scene_poses(**pose_kwargs),
                    Jsyn.synthetic_scene_poses(**pose_kwargs)):
        assert np.array_equal(a, b)
    assert np.array_equal(Tsyn.default_synthetic_K(kwargs["size"]),
                          Jsyn.default_synthetic_K(kwargs["size"]))


_IMPORT_ALL = """
import importlib, pkgutil, sys
import structure_from_motion_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "structure_from_motion_tpu")
             or k.startswith(("jax.", "jaxlib.", "structure_from_motion_tpu.")))
print(len(names), "modules;", "foreign:", bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_importing_the_port_loads_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FOREIGN_IMPORT = re.compile(r"^\s*(from|import)\s+(structure_from_motion_tpu|jax|jaxlib)(\.|\s|$)")


def _port_sources():
    return sorted((ROOT / "structure_from_motion_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def test_no_source_line_imports_the_jax_package():
    files = _port_sources()
    assert len(files) > 20
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if _FOREIGN_IMPORT.match(line)]
    assert not hits, hits


@pytest.mark.parametrize("entry, param", [
    ("models.incremental:IncrementalSfM", "device"),
    ("models.tracks:init_state", "device"),
    ("convert:state_from_numpy", "device"),
    ("utils.checkpoint:load_state", "device"),
    ("io.prefetch:DevicePrefetcher", "device"),
])
def test_entry_points_default_to_the_card(entry, param):
    import importlib

    mod, name = entry.split(":")
    fn = getattr(importlib.import_module(f"structure_from_motion_tpu_torch.{mod}"), name)
    assert inspect.signature(fn).parameters[param].default == "cuda"
