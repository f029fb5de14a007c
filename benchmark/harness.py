"""The benchmark's plumbing: BENCHMARK.json and the files it names, the
peak-memory meter, the correctness verdict, the import guard and the
result line. Everything that belongs to one configuration, traffic mix,
cell or per-layer metric lives in a file of its own, found by name:

  benchmark/configs/<config>.json      the configuration as it is run
  benchmark/traffic/<traffic>.json     a traffic mix: parameters and the
                                       name of the driver that runs them
  benchmark/traffic/<driver>.py        one driver per kind of traffic
  benchmark/workloads/<cell>.json      a cell's correctness limits and the
                                       readings they were set from
  benchmark/metrics/<metric>.py        one reader per per-layer metric
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dogs_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(spec_: dict, name: str) -> dict:
    for wl in spec_["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec_: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec_["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def workload_file(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def driver(name: str):
    return importlib.import_module(f"benchmark.traffic.{name}")


def metric_reader(name: str):
    """The module of benchmark/metrics/<name>.py (names hold dots, so it is
    loaded by path)."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_name = "benchmark.metrics." + name.replace(".", "__")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    loader_spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(loader_spec)
    loader_spec.loader.exec_module(mod)
    sys.modules[mod_name] = mod
    return mod


def metrics_of(spec_: dict, cell_name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` entries that a cell reports."""
    return [m for m in spec_[kind] if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `dogs_tpu_torch` is not `dogs_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


class PeakMeter:
    """`torch.cuda.max_memory_allocated` over the program's parts of a run:
    `start` before the program works, `stop` before the benchmark's own
    work, so the reference and the checks never set the peak."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.peak = 0

    def start(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.device))


@dataclasses.dataclass
class Check:
    """One compared number: the program's gap to the reference (or its count
    of misses) and the largest gap the cell allows."""

    name: str
    value: float
    limit: float | None

    @property
    def ok(self) -> bool:
        return self.limit is not None and self.value == self.value and self.value <= self.limit


def checks_from(readings: dict, limits: dict) -> list[Check]:
    """Checks of `readings` (name -> number) against the cell's limits
    (name -> {"limit": ...}); a number with no limit fails."""
    return [Check(k, float(v), (limits.get(k) or {}).get("limit")) for k, v in readings.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, checks: list[Check],
                breakdown: dict | None = None) -> str:
    out = dict(correct=bool(correct), attempted=int(attempted), failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return json.dumps(out)
