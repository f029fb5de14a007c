"""On the card: one short run of every cell through the command the driver
runs, `correct` true and the result line as the contract has it. Marked
`cuda`; each test skips when no CUDA device is present."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")
    seconds = harness.spec()["run_seconds"]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", "97531", "--seconds",
                          str(seconds), "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0


def test_run_without_a_card_fails():
    """Without CUDA the command exits 1 and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
