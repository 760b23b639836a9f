"""The benchmark's own CPU tests: ``python -m pytest benchmark/tests -q`` from
the repository root. Tests marked ``cuda`` skip without a card; on the card
``python -m pytest benchmark/tests -q -m cuda`` runs them."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture(scope="session")
def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="session", params=["BENCHMARK.json", "benchmark/pending.json"])
def cells(request) -> dict:
    """Either file of cells: both hold to the contract's names and files."""
    return json.loads((ROOT / request.param).read_text())


@pytest.fixture(scope="session")
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
