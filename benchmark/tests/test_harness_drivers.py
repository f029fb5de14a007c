"""Every traffic driver on the CPU at tiny sizes, through the harness's
run: the result line's keys, the per-layer metrics of a traced run, and
`correct` coming out false with the timed path broken underneath."""

from __future__ import annotations

import copy
import dataclasses
import json
import time

import pytest
import torch

from benchmark import harness
from benchmark import run as run_mod
from benchmark.tests import tiny

CELLS = [w["name"] for w in harness.spec()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run_tiny(name: str, capsys, trace: bool = False, seed: int = 3141592653) -> dict:
    spec, wl, cfg, traffic = tiny.cell(name)
    limits = harness.workload_file(name)["limits"]
    rc = run_mod.run_cell(spec, wl, seed, tiny.SECONDS[traffic["driver"]], trace, torch.device("cpu"),
                          time.perf_counter(), cfg=cfg, traffic=traffic, limits=limits)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run(name, capsys):
    out = run_tiny(name, capsys)
    assert list(out) == KEYS
    spec = harness.spec()
    assert set(out["metrics"]) == {m["name"] for m in harness.metrics_of(spec, name, "end_to_end")}
    assert out["device"]["platform"] == "cpu" and out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run(name, capsys):
    out = run_tiny(name, capsys, trace=True)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    names = {m["name"] for m in harness.metrics_of(harness.spec(), name, "per_layer")}
    assert set(out["metrics"]) <= names
    assert {"busy_s", "window_s"} <= set(out["device"]) and out["device"]["window_s"] > 0


def _state_unchanged(step):
    def broken(state, *args):
        _, metrics = step(copy.deepcopy(state), *args)
        return state, metrics
    return broken


def _half_batch(step):
    """The step on the top half of the image only: half the pixels left
    out, the mean taken over the rest."""
    def broken(state, camera, gt, *args):
        half = dataclasses.replace(camera, height=camera.height // 2)
        return step(state, half, gt[: camera.height // 2], *args)
    return broken


def _break_steps(monkeypatch, wrap):
    from dogs_tpu_torch.fields import scaffold
    from dogs_tpu_torch.train import trainer

    for mod, name in ((trainer, "make_train_step"), (scaffold, "make_scaffold_step")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, **k: wrap(_real(*a, **k)))


TRAINING = [c for c in CELLS if not c.endswith("serve_4m")]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch], ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", TRAINING)
def test_broken_step_is_not_correct(name, fault, capsys, monkeypatch):
    _break_steps(monkeypatch, fault)
    assert not run_tiny(name, capsys)["correct"]


def test_altered_frame_is_not_correct(capsys, monkeypatch):
    from dogs_tpu_torch.eval.evaluator import GaussianSplatEvaluator

    real = GaussianSplatEvaluator.render

    def altered(self, camera):
        img = real(self, camera).clone()
        img[:8, :8] = torch.clamp(img[:8, :8] + 0.25, 0.0, 1.0)
        return img

    monkeypatch.setattr(GaussianSplatEvaluator, "render", altered)
    assert not run_tiny("gs3d_urban3d.serve_4m", capsys)["correct"]
