"""Whole runs of the harness on the CPU at tiny sizes, through the port's
plain operators (the harness's look for a card skipped): a global solve, and
a stream and a lane batch of ``pending.json``, come out correct, and each
fault a cell can have, planted in the timed path, makes ``correct`` false;
so does the global solve's control (its reference in TF32). At the cells'
sizes these run on the card (``--control 1``, ``--fault <name>``)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def tiny() -> dict:
    """The CLI default at a size the CPU runs in seconds a frame."""
    conf = json.loads((ROOT / "benchmark" / "configs" / "cli_default.json").read_text())
    pl = conf["pipeline"]
    pl["frontend"].update(max_keypoints=256, upsample_first_octave=False, num_octaves=4)
    pl["capacity"].update(max_views=4, max_keypoints=256, max_points=2048,
                          max_observations=8192)
    pl["window_size"] = 4
    pl["pnp_ransac"]["score_subset"] = 0
    conf["frame_size"] = [120, 160]
    return conf


@pytest.fixture(scope="module")
def checkpoint(tiny, tmp_path_factory) -> str:
    """A slide-mode run of 12 frames, saved before its global solve."""
    import torch

    from benchmark.reference import scene
    from structure_from_motion_tpu_torch.config import PipelineConfig
    from structure_from_motion_tpu_torch.models.incremental import IncrementalSfM

    torch.manual_seed(0)
    size = tuple(tiny["frame_size"])
    frames = scene.render(12, size, 5, 0.84).numpy()
    K, _, _ = scene.path_poses(12, size, 0.84)
    eng = IncrementalSfM(PipelineConfig.from_json(json.dumps(tiny["pipeline"])), K, seed=5,
                         device="cpu")
    for f in frames:
        eng.process_image(f)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.ckpt.npz"
    eng.save_checkpoint(str(path))
    return str(path)


def _stream(pending, tiny, lanes=0, fault=None):
    traffic = {"driver": "stream", "ring_frames": 40, "loops": 1.4, "texture_seed": 3,
               "lanes": lanes, "lane_offset": 5, "profiled_steps": 2}
    cell = "cli_default.lanes8" if lanes else "cli_default.stream"
    return run.execute(pending, cell, SEED, 2.0, False, "cpu", fault=fault,
                       cell_files={"config": tiny, "traffic": traffic,
                                   "limits": {"ate_pct": 10.0}})


def _solve(bench, tiny, checkpoint, control=False, fault=None):
    traffic = {"driver": "global_solve", "checkpoint": checkpoint, "iterations": 5,
               "warm_solves": 1}
    return run.execute(bench, "midseq_w8.global500", SEED, 1.0, False, "cpu", control=control,
                       fault=fault, cell_files={"config": tiny, "traffic": traffic,
                                                "limits": {"cost0_gap": 1e-4, "cost_gap": 3e-2}})


def test_stream_is_correct_and_reports_its_metrics(pending, tiny):
    res = _stream(pending, tiny)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["checks"]["ate_pct"]["limit"] == 10.0
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["metrics"]) == {"frames_per_s", "frame_p95_ms", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])


def test_lanes_are_correct(pending, tiny):
    res = _stream(pending, tiny, lanes=2)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def test_solve_is_correct(bench, tiny, checkpoint):
    res = _solve(bench, tiny, checkpoint)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"global_solve_s", "setup_s"}


def test_solve_control_is_not_correct(bench, tiny, checkpoint):
    res = _solve(bench, tiny, checkpoint, control=True)
    assert not res["correct"]
    assert res["checks"]["cost0_gap"]["value"] > 3 * 1e-4


@pytest.mark.parametrize("cell,fault", [("stream", "unchanged"), ("stream", "altered"),
                                        ("lanes", "half_lanes"), ("solve", "unchanged")])
def test_faults_are_caught(bench, pending, tiny, checkpoint, cell, fault):
    if cell == "solve":
        res = _solve(bench, tiny, checkpoint, fault=fault)
    else:
        res = _stream(pending, tiny, lanes=2 if cell == "lanes" else 0, fault=fault)
    assert not res["correct"], res["checks"]


def test_no_card_no_result(bench, tmp_path):
    """Without a card the command exits non-zero and prints nothing; in a
    directory holding only BENCHMARK.json and the benchmark's files too."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for where in (ROOT, tmp_path):
        for cell in bench["workloads"]:
            out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                                  cell["name"], "--seed", "1", "--seconds", "1",
                                  "--trace", "0"], cwd=where, capture_output=True, text=True)
            assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(pending, tiny):
    """The same tiny stream through the kernels and the frame graph."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    traffic = {"driver": "stream", "ring_frames": 40, "loops": 1.4, "texture_seed": 3,
               "lanes": 0, "profiled_steps": 2}
    res = run.execute(pending, "cli_default.stream", SEED, 2.0, True, "cuda",
                      cell_files={"config": tiny, "traffic": traffic,
                                  "limits": {"ate_pct": 10.0}})
    assert res["correct"] and res["device"]["busy_s"] > 0
