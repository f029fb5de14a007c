"""The port's bench (`python -m dogs_tpu_torch.bench`) against bench.py:
the quality workload and its block split on the same seeds, every mode's
line contract at a tiny size on the CPU, the CLI's dispatch, its refused
TPU flags, and that it needs a CUDA device."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench as jbench
from dogs_tpu.raster.tiled import RasterConfig as JRasterConfig
from dogs_tpu.raster.tiled import render_tiled as j_render_tiled
from dogs_tpu_torch import bench
from dogs_tpu_torch.core import params_from_numpy
from dogs_tpu_torch.data import synthetic
from tests.test_torch_core import jax_params

REPO = Path(__file__).resolve().parents[1]
FWD_ATOL = 3e-4  # forward parity bar of tests/test_pallas_blend.py:32
TINY = dict(width=64, height=48, device="cpu")
QUALITY_TINY = dict(n_teacher=800, n_views=8, focal=50.0, **TINY)
# bench.py's keys of each mode's line (bench.py:200-206, 358-366, 467-481,
# 541-549, 590-598, 779-786, 838-845, 999-1009, 1071-1081).
BASE = {"metric", "value", "unit", "vs_baseline"}
KEYS = {
    "headline": BASE | {"truncation", "chain_steps", "kernels"},
    "scaling": BASE | {"truncation", "chain_steps"},
    "densify": BASE | {"chain_steps", "n_final", "truncation", "final_budgets"},
    "quality": BASE | {"wall_s", "iters_per_sec", "n_final"},
    "admm": BASE | {"truncation"},
    "consensus": BASE | {"pct_of_interval_at_12its"},
    "quality_admm": BASE | {"wall_s", "iters_per_sec", "n_global", "n_fused_alive"},
    "scaffold": BASE | {"n_anchors", "n_neural", "truncation"},
    "scaffold_quality": BASE | {"wall_s", "iters_per_sec", "n_anchors"},
}
MODES = {
    "headline": lambda: bench.bench_headline(n=300, warmup=2, iters=2, **TINY),
    "scaling": lambda: bench.scaling_curve(ns=(200, 400), warmup=1, iters=1, **TINY),
    "densify": lambda: bench.bench_densify(cadence=2, n=300, warm=4, timed=4, **TINY),
    "quality": lambda: bench.bench_quality(steps=6, densify_start=2, **QUALITY_TINY),
    "admm": lambda: bench.bench_admm(n=300, warm_intervals=1, timed_intervals=1, consensus_interval=2, **TINY),
    "consensus": lambda: bench.bench_consensus(gs=(300, 600), warm=1, iters=2, device="cpu"),
    "quality_admm": lambda: bench.bench_quality_admm(blocks="2x1", steps=8, densify_start=1, consensus_interval=4,
                                                     **QUALITY_TINY),
    "scaffold": lambda: bench.bench_scaffold(n=300, warm=2, timed=2, **TINY),
    "scaffold_quality": lambda: bench.bench_scaffold_quality(steps=4, **QUALITY_TINY),
}
LINES = {"scaling": 2, "consensus": 2}


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads for this file's small tensors (the parallel test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    """bench.py's `_quality_scene` at tests/test_bench_contract.py:97's
    arguments, in both packages."""
    kw = dict(n_teacher=800, width=96, height=72, n_views=8, focal=80.0)
    return jbench._quality_scene(use_pallas=False, **kw), bench.quality_scene(**kw, device="cpu")


def test_quality_scene_matches_bench_py(scenes):
    """The cameras and splits (to 1e-6, where JAX computes them), the
    student's points bit for bit, its colours to 1e-6 (JAX's sh_to_rgb) and
    the GT images at the forward bar. bench.py renders its teacher under a
    two-tier bin budget (4 base tiles, a pool of n_teacher entries), which
    at this size drops entries; the port renders it under the same budget
    (`bench.render_budgeted`), so its images are bench.py's. The teacher's
    arrays are bench.py's too: dogs_tpu renders the port's teacher under the
    budget to bench.py's images."""
    (jtc, jti, jvc, jvi, jpts, jcols), (ttc, tti, tvc, tvi, tpts, tcols) = scenes
    teacher = jax_params(synthetic.quality_teacher_arrays(800))
    budget = JRasterConfig(max_tiles_per_gaussian=12, use_pallas=False, base_tiles=4, overflow_capacity=800)
    render_under_budget = jax.jit(lambda c: j_render_tiled(teacher, c, budget, active_sh_degree=0))  # as bench.py
    truncated = 0
    for t, j, cam in zip(tti + tvi, jti + jvi, jtc + jvc):
        under_budget = render_under_budget(cam)
        truncated += int(under_budget.bin_pool_truncated)
        np.testing.assert_allclose(np.asarray(under_budget.image), np.asarray(j), rtol=0, atol=1e-6)
        assert isinstance(t, np.ndarray) and t.dtype == np.float32 and t.shape == (72, 96, 3)
        np.testing.assert_allclose(t, np.asarray(j), atol=FWD_ATOL)
    assert truncated > 0
    assert max(float(np.asarray(j).max()) for j in jti) > 0.3  # the teacher is in view
    assert [int(c.image_index) for c in jtc] == [c.image_index for c in ttc] == [0, 1, 3, 4, 5, 7]
    assert [int(c.image_index) for c in jvc] == [c.image_index for c in tvc] == [2, 6]
    for tc, jc in zip(ttc + tvc, jtc + jvc):
        assert (tc.width, tc.height) == (jc.width, jc.height) == (96, 72)
        for f in ("R", "t", "fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(np_(getattr(tc, f)), np.asarray(getattr(jc, f)), rtol=1e-6, atol=1e-6,
                                       err_msg=f)
    assert tpts.dtype == jpts.dtype and tpts.shape == (400, 3)
    np.testing.assert_array_equal(tpts, jpts)
    assert tcols.dtype == np.asarray(jcols).dtype == np.float32
    np.testing.assert_allclose(tcols, np.asarray(jcols), rtol=0, atol=1e-6)


def test_budget_tool_reproduces_bench_py_s_truncated_gt(scenes):
    """`bench.render_budgeted` (the quality GT's renderer, which
    tools/quality_gt_budget.py compares with the exact render) drops exactly
    what dogs_tpu's two-tier pool drops: the same pool need and truncated
    Gaussians per view as dogs_tpu's render reports, and its render equals
    bench.py's images at the forward bar."""
    (jtc, jti, jvc, jvi, _, _), (ttc, _, tvc, _, _, _) = scenes
    arrays = synthetic.quality_teacher_arrays(800)
    teacher, j_teacher = params_from_numpy(arrays, "cpu"), jax_params(arrays)
    budget = JRasterConfig(max_tiles_per_gaussian=12, use_pallas=False, base_tiles=4, overflow_capacity=800)
    dropped = 0
    for tc, jc, j in zip(ttc + tvc, jtc + jvc, jti + jvi):
        want = j_render_tiled(j_teacher, jc, budget, active_sh_degree=0)
        got, stats = bench.render_budgeted(teacher, tc, pool=800)
        assert stats["pool_need"] == int(want.bin_pool_need)
        assert stats["pool_truncated"] == int(want.bin_pool_truncated)
        assert stats["entries"] - stats["entries_dropped"] == int(want.bin_valid)
        np.testing.assert_allclose(np_(got), np.asarray(j), atol=FWD_ATOL)
        dropped += stats["entries_dropped"]
    assert dropped > 0


def test_split_blocks_matches_bench_py(scenes):
    """At 2x1: the same camera labels and point masks, so the same blocks."""
    (jtc, jti, _, _, jpts, jcols), (ttc, tti, _, _, tpts, tcols) = scenes
    jpart, jbc, _, jbp, _ = jbench._split_blocks(jtc, jti, jpts, jcols, mx=2, my=1)
    tpart, tbc, tbi, tbp, tbcol = bench.split_blocks(ttc, tti, tpts, tcols, mx=2, my=1)
    np.testing.assert_array_equal(tpart.camera_labels, jpart.camera_labels)
    assert len(tpart.point_masks) == 2
    for k in range(2):
        np.testing.assert_array_equal(tpart.point_masks[k], jpart.point_masks[k])
        assert [c.image_index for c in tbc[k]] == [int(c.image_index) for c in jbc[k]]
        assert len(tbi[k]) == len(tbc[k]) and len(tbp[k]) == len(tbcol[k]) == len(jbp[k]) > 0
        np.testing.assert_array_equal(tbp[k], jbp[k])


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_prints_bench_py_lines(mode, capsys):
    """Each mode at a tiny size on the CPU: one line (one per point of a
    sweep) with bench.py's keys plus `device` and `peak_mib`, a finite
    value, vs_baseline null; no device number off the card."""
    lines = MODES[mode]()
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert printed == lines and len(lines) == LINES.get(mode, 1)
    for line in lines:
        assert set(line) == KEYS[mode] | {"device", "peak_mib"}, line
        assert np.isfinite(line["value"]) and line["vs_baseline"] is None
        assert line["device"] == "cpu" and line["peak_mib"] is None
        assert line.get("truncation", 0) == 0 and line.get("chain_steps", 1) == 1
    if mode in ("quality", "quality_admm", "scaffold_quality"):
        assert lines[0]["unit"] == "dB" and lines[0]["wall_s"] >= 0
    elif mode == "consensus":
        assert [line["metric"] for line in lines] == ["consensus_step_0k_1block"] * 2
    else:
        assert lines[0]["unit"] == "iters/sec" and lines[0]["value"] > 0


def test_metric_names_at_bench_py_sizes_are_bench_py_s(monkeypatch, capsys):
    """At bench.py's sizes the port names its lines as bench.py does
    (bench.py:359, 839), so each pairs with its JAX counterpart."""
    monkeypatch.setattr(bench, "measure", lambda *a, **kw: (1.0, 0))
    lines = bench.bench_headline(device="cpu") + bench.scaling_curve(device="cpu")
    assert [line["metric"] for line in lines] == [
        "rubble_like_500k_1152x864_full_train_step",
        *(f"scaling_{n}k_1152x864_full_train_step" for n in (500, 1000, 2000, 4000)),
    ]
    assert lines[0]["kernels"] == "plain"
    capsys.readouterr()


def test_quality_diagnostics(monkeypatch, tmp_path, capsys):
    """DOGS_QUALITY_DIAG: bench.py's probes, one line per SH degree, and val
    view 0's render and GT saved under out/."""
    monkeypatch.setenv("DOGS_QUALITY_DIAG", "1")
    monkeypatch.chdir(tmp_path)
    bench.bench_quality(steps=2, **QUALITY_TINY)
    diag = [json.loads(s) for s in capsys.readouterr().out.splitlines() if "diag_sh_degree" in s]
    assert [d["diag_sh_degree"] for d in diag] == [0, 1, 2, 3]
    assert all(len(d["val_psnr"]) == 2 and len(d["train_psnr_eval_path"]) == 2 for d in diag)
    render, gt = np.load(tmp_path / "out" / "qdiag_val0_render.npy"), np.load(tmp_path / "out" / "qdiag_val0_gt.npy")
    assert render.shape == gt.shape == (48, 64, 3)


ARGV = {
    "": ("bench_headline", {}),
    "--scaling": ("scaling_curve", {}),
    "--densify --cadence 100 --no-events": ("bench_densify", dict(cadence=100, no_events=True)),
    "--quality --steps 1200": ("bench_quality", dict(steps=1200)),
    "--admm --stream --gt-f32": ("bench_admm", dict(stream=True, gt_f32=True)),
    "--consensus": ("bench_consensus", {}),
    "--quality-admm --blocks 2x2 --steps 2400 --densify-start 200 --fusion-only --with-single": (
        "bench_quality_admm", dict(blocks="2x2", steps=2400, densify_start=200, fusion_only=True,
                                   with_single=True, n_cpu=0)),
    "--scaffold": ("bench_scaffold", {}),
    "--scaffold-quality --steps 600": ("bench_scaffold_quality", dict(steps=600)),
}


@pytest.mark.parametrize("argv", list(ARGV), ids=[a or "headline" for a in ARGV])
def test_cli_dispatches_as_bench_py(argv, monkeypatch):
    name, want = ARGV[argv]
    calls = []
    for fn in {n for n, _ in ARGV.values()}:
        monkeypatch.setattr(bench, fn, lambda _fn=fn, **kw: calls.append((_fn, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert bench.main(argv.split()) == 0
    assert len(calls) == 1 and calls[0][0] == name
    assert {k: v for k, v in calls[0][1].items() if k in want} == want


def test_quality_admm_cpu_runs_without_a_card(monkeypatch):
    """--quality-admm --cpu N is bench.py's one CPU run: no CUDA needed."""
    calls = []
    monkeypatch.setattr(bench, "bench_quality_admm", lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--quality-admm", "--cpu", "4", "--blocks", "2x2"]) == 0
    assert calls[0]["n_cpu"] == 4 and calls[0]["blocks"] == "2x2"
    assert bench.main(["--quality"]) == 1


@pytest.mark.parametrize("flag", list(bench.REFUSED))
def test_tpu_only_flags_are_refused(flag, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert bench.main([flag, "8"]) == 2
    err = capsys.readouterr().err
    assert f"{flag} is refused" in err and bench.REFUSED[flag] in err


def test_without_a_card_the_bench_exits_naming_the_device():
    """A fresh interpreter with no CUDA device: non-zero, no result line,
    the missing device named. There is no CPU fallback."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "dogs_tpu_torch.bench"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout.strip()


def test_budget_tool_prints_each_view_against_the_exact_render(capsys):
    """tools/quality_gt_budget.py: one line per view and a summary; the
    budget drops entries at this size, so its render is not the exact one."""
    from dogs_tpu_torch.tools import quality_gt_budget

    quality_gt_budget.main(["--device", "cpu", "--n-teacher", "800", "--width", "96", "--height", "72",
                            "--views", "4", "--focal", "80"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [line["view"] for line in lines[:-1]] == [0, 1, 2, 3] and lines[-1]["views"] == 4
    assert sum(line["entries_dropped"] for line in lines[:-1]) > 0
    assert np.isfinite(lines[-1]["psnr_budget_vs_exact_mean"])
