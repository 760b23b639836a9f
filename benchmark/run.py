"""Runs one cell of the benchmark of ``structure_from_motion_tpu_torch`` once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``driver`` names the generator in
``benchmark/drivers/``); its limits are ``benchmark/limits/<cell>.json`` and
each per-layer metric is read by ``benchmark/metrics/<metric>.py``.

The run sets up (renders its inputs from the seed, builds the engine, warms
every shape the window uses), measures for ``--seconds``, then judges what
the timed path produced against the plain reference under
``benchmark/reference/``. With ``--trace 0`` it reports the cell's
end-to-end metrics; with ``--trace 1`` the same window runs with the
benchmark's spans and counters on, then a short window under
``torch.profiler``, and it reports the per-layer metrics. Each number
compared is printed beside its limit at the end of standard error; the last
line of standard output is one JSON object. Without enough CUDA cards it
exits 3 and prints no result; if ``jax``, ``jaxlib``, ``flax`` or the JAX
package was loaded, it exits 4.

``--control 1`` runs the cell's control instead of the program (each
driver says which: for the global solve, its reference computed in TF32 in
the program's place), and ``--fault <name>`` plants a fault of
``faults.py`` in the timed path; the benchmark's own runs pass neither.
``--cells <file>`` reads the cells from another file of ``BENCHMARK.json``'s
shape: ``benchmark/pending.json`` holds the cells that are not yet proven.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "structure_from_motion_tpu")


class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    seed, the window's length, the trace, the device, whether it runs the
    control, and two calls: ``window_started(t)`` and ``memory_peak()``."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
                 trace, device, control: bool = False, start: float = T0):
        from structure_from_motion_tpu_torch.config import PipelineConfig

        self.cell, self.config, self.traffic = cell, config, traffic
        self.pipeline = PipelineConfig.from_json(json.dumps(config["pipeline"]))
        self.seed = int(seed) % 2 ** 63
        self.seconds, self.trace, self.control = float(seconds), trace, bool(control)
        self.device = torch.device(device)
        self.start, self.setup_s = start, None

    def window_started(self, t: float) -> None:
        self.setup_s = t - self.start

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize()
        return int(max(torch.cuda.max_memory_allocated(i)
                       for i in range(torch.cuda.device_count())))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric_module(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def for_cell(metrics: list, cell: str) -> list:
    """The metrics of ``metrics`` that ``cell`` reports."""
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def execute(bench: dict, name: str, seed: int, seconds: float, trace_on: bool, device="cuda",
            control: bool = False, start: float = T0, cell_files: dict | None = None,
            fault: str | None = None) -> dict:
    """One run of cell ``name``: the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, [``breakdown``],
    ``info``: what the reference read besides the numbers compared,
    ``checks``: each number compared with its limit). ``cell_files`` may
    give the cell's ``config``, ``traffic`` and ``limits`` in place of its
    files (the CPU tests' small sizes); ``fault`` plants one of
    ``faults.NAMES`` in the timed path."""
    from benchmark import faults
    from benchmark.trace import Trace, breakdown

    cell = next(w for w in bench["workloads"] if w["name"] == name)
    files = dict(cell_files or {})
    if "config" not in files:
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        files["config"] = load_json(ROOT.parent / conf["file"])
    files.setdefault("traffic", load_json(ROOT / "traffic" / f"{cell['traffic']}.json"))
    files.setdefault("limits", load_json(ROOT / "limits" / f"{name}.json"))
    # the port turns TF32 off when its device module is imported: import it
    # first (a driver's control may turn it on)
    import structure_from_motion_tpu_torch.device  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = Trace(trace_on)
    ctx = Context(cell, files["config"], files["traffic"], seed, seconds, tr, device, control,
                  start)
    driver = importlib.import_module(f"benchmark.drivers.{files['traffic']['driver']}")
    with faults.planted(fault):
        out = driver.run(ctx)
    e2e = dict(out["e2e"], setup_s=ctx.setup_s)
    metrics = {}
    if trace_on:
        for m in for_cell(bench["per_layer"], name):
            value = _metric_module(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in for_cell(bench["end_to_end"], name):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    checks = {k: {"value": float(out["numbers"][k]), "limit": float(lim)}
              for k, lim in files["limits"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(0) if ctx.device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace_on and tr.device is not None:
        dev["busy_s"] = float(out["busy_s"])
        dev["window_s"] = float(tr.device["window_s"])
        result["breakdown"] = breakdown(tr.device)
    result["info"] = dict(out.get("info", {}), numbers=out["numbers"])
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0, help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    p.add_argument("--cells", default="BENCHMARK.json", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    bench = load_json(ROOT.parent / a.cells)
    cell = next((w for w in bench["workloads"] if w["name"] == a.workload), None)
    if cell is None:
        print(f"no workload {a.workload!r} in {a.cells}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    result = execute(bench, a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                     bool(a.control), fault=a.fault)
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: refused", file=sys.stderr)
        return 4
    print(json.dumps(result.pop("info")), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
