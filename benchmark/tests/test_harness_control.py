"""The control of each cell comes out not correct: the program with its
bfloat16 gradient reduce (`reduce_dtype="bf16"`) in the training cells, the
reference render in bfloat16 in the program's place in the serving cell,
on the CPU at tiny sizes, against the cell's limits (benchmark/calibrate.py
reads the same controls on the card at the cells' own sizes)."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import calibrate, harness
from benchmark import run as run_mod
from benchmark.tests import tiny

CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, capsys):
    spec, wl, cfg, traffic = tiny.cell(name)
    cfg.update(calibrate.CONTROL[traffic["driver"]])
    rc = run_mod.run_cell(spec, wl, 2718281828, tiny.SECONDS[traffic["driver"]], False, torch.device("cpu"),
                          time.perf_counter(), cfg=cfg, traffic=traffic, limits=harness.workload_file(name)["limits"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not out["correct"], out["checks"]
