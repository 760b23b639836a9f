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


@pytest.fixture(scope="session")
def pending() -> dict:
    """The cells that wait for a comparison their control fails."""
    return json.loads((ROOT / "benchmark" / "pending.json").read_text())


@pytest.fixture(scope="session", params=["BENCHMARK.json", "benchmark/pending.json"])
def cells(request) -> dict:
    """Either file of cells: both hold to the contract's names and files."""
    return json.loads((ROOT / request.param).read_text())
