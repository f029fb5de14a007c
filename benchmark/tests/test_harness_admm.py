"""The ADMM cell's driver on the CPU at a tiny size (four gloo ranks): a
traced sound run, planted faults of the round (rank 0's block left out of
the average, the dual update's sign flipped) and of the penalty (dropped,
its sign flipped, on rank 0's block) coming out not correct, and its
readers on hand-made observations.

Importing this module registers the `admm_consensus` traffic driver's
tiny size and control with the shared helpers (benchmark/tests/tiny.py,
benchmark/calibrate.py), which the other harness tests read for every
cell."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import calibrate, harness, profiling
from benchmark import run as run_mod
from benchmark.tests import tiny

CELL = "dogs_admm_urban3d.consensus_2x2"
tiny.SIZES.setdefault("admm_consensus", dict(n_global=3000, n_teacher=2000, views_per_block=4, timed_rounds=1,
                                             rank_timeout_s=120, overrides=dict(consensus_interval=5)))
tiny.SECONDS.setdefault("admm_consensus", 2.0)
calibrate.CONTROL.setdefault("admm_consensus", {"reduce_dtype": "bf16", "round_dtype": "bfloat16"})


def run_tiny(capsys, trace=False, cfg_update=None):
    spec, wl, cfg, traffic = tiny.cell(CELL)
    cfg.update(cfg_update or {})
    rc = run_mod.run_cell(spec, wl, 2718281828, tiny.SECONDS["admm_consensus"], trace, torch.device("cpu"),
                          time.perf_counter(), cfg=cfg, traffic=traffic, limits=harness.workload_file(CELL)["limits"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_traced_run_reads_every_admm_metric(capsys):
    out = run_tiny(capsys, trace=True)
    assert out["correct"], out["checks"]
    # No device kernels on the CPU: the all-reduce and idle shares read nothing.
    assert set(out["metrics"]) == {"consensus_ms.admm"} and out["metrics"]["consensus_ms.admm"]["value"] > 0


def _left_out(monkeypatch):
    from dogs_tpu_torch.parallel import admm

    real = admm.shared_zsum
    monkeypatch.setattr(admm, "shared_zsum", lambda *a, **k: torch.zeros_like(real(*a, **k)))


def _flipped(monkeypatch):
    from dogs_tpu_torch.parallel import admm

    real = admm.dual_update
    monkeypatch.setattr(admm, "dual_update",
                        lambda u, x, z, alive, c: {k: 2 * u[k] - v for k, v in real(u, x, z, alive, c).items()})


@pytest.mark.parametrize("fault", [_left_out, _flipped], ids=["block_left_out", "dual_sign_flipped"])
def test_a_broken_round_is_not_correct(fault, capsys, monkeypatch):
    """Rank 0's part of the round broken (the other ranks run the program
    as it is)."""
    fault(monkeypatch)
    out = run_tiny(capsys)
    assert not out["correct"], out["checks"]


def obs(spans=None, counts=None, kernels=(), window_s=1.0, busy_s=0.5):
    return profiling.Observation(spans or {}, counts or {}, list(kernels), window_s, busy_s)


def _scaled_penalty(factor):
    def plant(monkeypatch):
        from dogs_tpu_torch.train import trainer

        real = trainer.make_train_step

        def make(*a, **k):
            step = real(*a, **k)
            if not k.get("admm"):
                return step
            return lambda ts, cam, gt, u, z, rho: step(ts, cam, gt, u, z, {n: v * factor for n, v in rho.items()})

        monkeypatch.setattr(trainer, "make_train_step", make)
    return plant


@pytest.mark.parametrize("fault", [_scaled_penalty(0.0), _scaled_penalty(-1.0)],
                         ids=["penalty_dropped", "penalty_sign_flipped"])
def test_a_broken_penalty_is_not_correct(fault, capsys, monkeypatch):
    """Rank 0's block trains without its penalty, or with its sign
    flipped: the steps after the first round, where u and z_local are away
    from x, see it."""
    fault(monkeypatch)
    out = run_tiny(capsys)
    assert not out["correct"] and out["checks"]["penalty_gap"]["value"] > 0.5, out["checks"]


def test_readers_on_hand_made_observations():
    rounds = harness.metric_reader("consensus_ms.admm")
    assert rounds.read(obs({"admm_round_s": [0.010, 0.020]})) == pytest.approx(15.0)
    assert rounds.read(obs()) is None
    bw = harness.metric_reader("allreduce_busbw_pct.admm")
    counts = {"admm_round_bytes": 900e6, "admm_ranks": 4, "admm_rounds_profiled": 1}
    kernels = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 0.0, 2500.0),
               ("ncclDevKernel_AllReduce_Sum_f32", 0, 500.0), ("blend_forward_kernel", 0.0, 9000.0)]
    # 900 MB x 1.5 over 3 ms is 450 GB/s: all of the link.
    assert bw.read(obs(counts=counts, kernels=kernels)) == pytest.approx(100.0)
    assert bw.read(obs(counts=counts, kernels=kernels[2:])) is None
    assert bw.read(obs(kernels=kernels)) is None
    idle = harness.metric_reader("device_idle_pct.admm")
    assert idle.read(obs(kernels=kernels)) == pytest.approx(50.0)
