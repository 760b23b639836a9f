"""``BENCHMARK.json`` against the benchmark's contract, and every file the
harness finds by name."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == TOP
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_names_units_and_keys(cells):
    bench = cells
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])
    assert {w["config"] for w in bench["workloads"]} == set(names)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_enough(cells):
    bench = cells
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        mine = [m["name"] for m in bench["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(_reports(m, w["name"]) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        cells = m.get("workloads", [w["name"] for w in bench["workloads"]])
        for cell in cells:  # the end-to-end metric it moves is reported there
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_four_chip_share(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_files_found_by_name(cells):
    bench = cells
    from structure_from_motion_tpu_torch.config import PipelineConfig

    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.is_relative_to(BENCH)
        conf = json.loads(path.read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        PipelineConfig.from_json(json.dumps(conf["pipeline"]))
    for w in bench["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v > 0 for v in limits.values())
    for m in bench["per_layer"]:
        spec = importlib.util.spec_from_file_location("m", BENCH / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


@pytest.mark.parametrize("name,builder", [("cli_default", "cli_default_config"),
                                          ("midseq_w8", "_long_sequence_config")])
def test_configs_are_their_sources(name, builder):
    """Nothing is cut: each file holds its source's settings unchanged."""
    from structure_from_motion_tpu_torch.tools import slice_frames

    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert conf["reduced"] == []
    assert conf["pipeline"] == json.loads(getattr(slice_frames, builder)().to_json())
