"""The self-calibrating solve cell's driver (``drivers/bal_solve.py``) on
the CPU at a small size, through the port's plain operators: correct under
the cell's limits, and not correct with its control (the reference in TF32)
or with the LM's steps left out; its reference copy
(``reference/bal_ba.py``) gives the test suite's reference's numbers on the
same arrays."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import torch

from benchmark import run
from benchmark.drivers import bal_solve
from benchmark.reference import bal_ba, bal_scene

ROOT = Path(__file__).resolve().parents[2]
CELL = "bal_venice1778.solve20"
SEED = 2 ** 31 + 17


def _small() -> dict:
    """The configuration at 12 cameras, 400 points, 2,000 observations."""
    conf = json.loads((ROOT / "benchmark" / "configs" / "bal_venice1778.json").read_text())
    conf["counts"] = {"cameras": 12, "points": 400, "observations": 2000}
    return conf


def _solve(bench, control=False, fault=None):
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{CELL}.json").read_text())
    traffic = {"driver": "bal_solve", "iterations": 5, "warm_solves": 1}
    return run.execute(bench, CELL, SEED, 1.0, False, "cpu", control=control, fault=fault,
                       cell_files={"config": _small(), "traffic": traffic, "limits": limits})


def test_the_cell_is_correct_and_reports_its_metrics(bench):
    res = _solve(bench)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"cost0_gap", "cost_gap"}
    assert set(res["metrics"]) == {"global_solve_s", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    info = res["info"]
    assert info["camera_view"]["obs"] == 2000 and info["intr_gap"]["k1"] < 1e-3


def test_the_control_and_a_frozen_lm_are_not_correct(bench):
    assert not _solve(bench, control=True)["correct"]
    res = _solve(bench, fault="unchanged")
    assert not res["correct"] and res["checks"]["cost_gap"]["value"] > 0.1


def test_the_draw_has_the_counts_and_keeps_every_observation_in_frame():
    conf = _small()
    d = bal_scene.draw(SEED, 12, 400, 2000, bal_solve.settings(conf), "cpu")
    assert d["cam"].shape == (2000,) and d["cameras"].shape == (12, 9)
    counts = np.bincount(d["point"].numpy(), minlength=400)
    assert counts.min() >= 2 and counts.sum() == 2000
    pairs = d["cam"].long() * 400 + d["point"].long()
    assert pairs.unique().shape[0] == 2000  # a track's cameras are distinct
    again = bal_scene.draw(SEED, 12, 400, 2000, bal_solve.settings(conf), "cpu")
    assert all(torch.equal(d[k], again[k]) for k in d)


def test_the_reference_copy_is_the_test_suites_reference():
    spec = importlib.util.spec_from_file_location("suite_ref", ROOT / "tests" / "bal_reference.py")
    suite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(suite)
    conf = _small()
    d = bal_scene.draw(SEED, 12, 400, 2000, bal_solve.settings(conf), "cpu")
    arrays = [d[k] for k in ("cameras", "points", "cam", "point", "xy")]
    ba = dataclasses.asdict(run.Context(None, conf, {}, 0, 0, None, "cpu").pipeline.ba)
    for precision in ("f64", "tf32"):
        dt = torch.float64 if precision == "f64" else torch.float32
        a = bal_ba.solve(bal_ba.as_problem(*arrays, "cpu", dt), 3, ba, precision)
        b = suite.solve(suite.as_problem(*arrays, "cpu", dt), 3, ba, precision)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
