"""Whole runs of the harness on the CPU at tiny sizes, through the port's
plain operators (the harness's look for a card skipped): a global solve, a
stream and a lane batch come out correct, and each fault a cell can have,
planted in the timed path, makes ``correct`` false; so does the global
solve's control (its reference in TF32). At the cells' sizes these run on
the card (``--control 1``, ``--fault <name>``)."""

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


# the frame cells' limits at the tiny size: sound CPU runs read gaps of
# about 1e-6 (the program in float32 against the float64 reference)
FRAME_LIMITS = {"ate_pct": 10.0, "ba_cost0_gap": 1e-4, "ba_cost_gap": 1e-3}


def _stream(bench, tiny, lanes=0, fault=None, control=False):
    traffic = {"driver": "stream", "ring_frames": 40, "loops": 1.4, "texture_seed": 3,
               "lanes": lanes, "lane_offset": 5, "profiled_steps": 2}
    cell = "cli_default.lanes8" if lanes else "cli_default.stream"
    return run.execute(bench, cell, SEED, 2.0, False, "cpu", control=control, fault=fault,
                       cell_files={"config": tiny, "traffic": traffic, "limits": FRAME_LIMITS})


def _judged(frames: int, every: int) -> int:
    """The frames (steps) a window of ``frames`` judges: every ``every``-th
    from its first, and its last."""
    return len(set(range(0, frames, every)) | {frames - 1})


def _solve(bench, tiny, checkpoint, control=False, fault=None):
    traffic = {"driver": "global_solve", "checkpoint": checkpoint, "iterations": 5,
               "warm_solves": 1}
    return run.execute(bench, "midseq_w8.global500", SEED, 1.0, False, "cpu", control=control,
                       fault=fault, cell_files={"config": tiny, "traffic": traffic,
                                                "limits": {"cost0_gap": 1e-4, "cost_gap": 3e-2}})


def test_stream_is_correct_and_reports_its_metrics(bench, tiny):
    res = _stream(bench, tiny)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["checks"]["ate_pct"]["limit"] == 10.0
    assert set(res["checks"]) == set(FRAME_LIMITS)
    # every 16th frame of the window and its last are judged; on the CPU the
    # eager rerun is the timed path itself
    assert res["info"]["judged_lane_frames"] == _judged(res["attempted"], 16)
    assert res["info"]["empty_lane_frames"] == 0 and res["info"]["rerun_cost_gap"] <= 1e-6
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["metrics"]) == {"frames_per_s", "frame_p95_ms", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])


def test_lanes_are_correct(bench, tiny):
    res = _stream(bench, tiny, lanes=2)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert res["info"]["judged_lane_frames"] == 2 * _judged(res["attempted"], 4)


def test_stream_control_is_not_correct(bench, tiny):
    """The reference in TF32 in the per-frame BA's place."""
    res = _stream(bench, tiny, control=True)
    assert not res["correct"]
    assert res["checks"]["ba_cost0_gap"]["value"] > 3 * FRAME_LIMITS["ba_cost0_gap"]


def test_solve_is_correct(bench, tiny, checkpoint):
    res = _solve(bench, tiny, checkpoint)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"global_solve_s", "setup_s"}


def test_solve_control_is_not_correct(bench, tiny, checkpoint):
    res = _solve(bench, tiny, checkpoint, control=True)
    assert not res["correct"]
    assert res["checks"]["cost0_gap"]["value"] > 3 * 1e-4


@pytest.mark.parametrize("cell,fault", [("stream", "unchanged"), ("stream", "altered"),
                                        ("lanes", "half_lanes"), ("solve", "unchanged"),
                                        ("lanes", "unchanged")])
def test_faults_are_caught(bench, tiny, checkpoint, cell, fault):
    if cell == "solve":
        res = _solve(bench, tiny, checkpoint, fault=fault)
    else:
        res = _stream(bench, tiny, lanes=2 if cell == "lanes" else 0, fault=fault)
    assert not res["correct"], res["checks"]


def test_a_frozen_frame_ba_fails_its_cost_gap(bench, tiny, monkeypatch):
    """The per-frame BA's LM steps left out, and nothing else: the frames'
    cost trajectories stop following the reference's."""
    from structure_from_motion_tpu_torch.ops import ba

    monkeypatch.setattr(ba, "_apply_step", lambda state, dc, dp: state)
    res = _stream(bench, tiny)
    assert res["checks"]["ba_cost_gap"]["value"] > 3 * FRAME_LIMITS["ba_cost_gap"]
    assert not res["correct"]


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
def test_a_cell_runs_on_the_card(bench, tiny):
    """The same tiny stream through the kernels and the frame graph."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    traffic = {"driver": "stream", "ring_frames": 40, "loops": 1.4, "texture_seed": 3,
               "lanes": 0, "profiled_steps": 2}
    res = run.execute(bench, "cli_default.stream", SEED, 2.0, True, "cuda",
                      cell_files={"config": tiny, "traffic": traffic, "limits": FRAME_LIMITS})
    assert res["correct"] and res["device"]["busy_s"] > 0
    assert "frame_evict_ms" in res["metrics"]
