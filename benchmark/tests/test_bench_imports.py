"""What the benchmark loads: nothing of JAX or the JAX package in a run, and
nothing of the port in the reference."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "structure_from_motion_tpu"}


def _top_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_a_run_loads_no_jax():
    """Every module a run can import, and the port's modules it drives:
    top-level names compared whole (``structure_from_motion_tpu_torch`` is
    not ``structure_from_motion_tpu``)."""
    code = (
        "import sys, importlib, pathlib\n"
        "import benchmark.run, benchmark.trace, benchmark.counts, benchmark.faults\n"
        "import benchmark.drivers.stream, benchmark.drivers.global_solve\n"
        "from structure_from_motion_tpu_torch.models import incremental, batched, global_ba\n"
        "for p in pathlib.Path('benchmark/metrics').glob('*.py'):\n"
        "    benchmark.run._metric_module(p.stem)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "structure_from_motion_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_sources_import_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _top_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        assert "structure_from_motion_tpu_torch" not in _top_imports(path), path
        assert not _top_imports(path) & FORBIDDEN, path
