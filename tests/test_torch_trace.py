"""The program's spans (dogs_tpu_torch/utils/trace.py): a shared null
context with no profiler running, the span tree of a train step, a trainer
iteration and a served frame under a CPU `torch.profiler`, and
`program_spans` on hand-built Chrome events. One test needs the card and
skips without one: every host sync of a step, a Scaffold-GS step and a
frame is a `dogs.sync.*` span. The file imports no JAX, so it runs on the
card's machine as the CUDA lane does:

    python -m pytest tests/test_torch_trace.py --noconftest -q
"""

import contextlib
import json
import traceback
import warnings

import pytest
import torch

from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.eval.evaluator import GaussianSplatEvaluator
from dogs_tpu_torch.fields import scaffold as sc
from dogs_tpu_torch.raster.tiled import RasterConfig
from dogs_tpu_torch.train import trainer as ttrainer
from dogs_tpu_torch.utils import trace

STAGES = ["dogs.step.render", "dogs.step.loss", "dogs.step.backward", "dogs.step.adam", "dogs.step.stats"]
RASTER = ["dogs.raster.project", "dogs.raster.bin", "dogs.raster.entries", "dogs.raster.blend_fwd"]
BIN_SYNCS = ["dogs.sync.bin_expand", "dogs.sync.bin_cull", "dogs.sync.bin_truncated"]


def scene(device):
    return synthetic.make_scene(n_gaussians=64, n_cams=4, width=64, height=48, seed=0, device=device)


def train_step(sc_, device):
    cfg = ttrainer.TrainerConfig(max_sh_degree=2, min_capacity=128)
    ts = ttrainer.init_train_state(sc_.points, sc_.colors, len(sc_.cameras), cfg, device)
    step = ttrainer.make_train_step(cfg, RasterConfig(), 1.0, 2, (0.0, 0.0, 0.0))
    return lambda i: step(ts, sc_.cameras[i], sc_.images[i])


def scaffold_step(sc_, device):
    sp, alive = sc.init_scaffold(sc_.points, 0.05, 4, 0, device=device)
    state = sc.init_scaffold_state(sp, alive)
    step = sc.make_scaffold_step(sc.ScaffoldConfig(stat_start_iter=0), RasterConfig())
    return lambda i: step(state, sc_.cameras[i], sc_.images[i])


def evaluator(sc_, device):
    ts = ttrainer.init_train_state(sc_.points, sc_.colors, 1, ttrainer.TrainerConfig(min_capacity=128), device)
    return GaussianSplatEvaluator(ts.model)


def spans_of(prof, path) -> list:
    """The `dogs.` spans of a profile, in start order."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("dogs.")),
                  key=lambda e: e["ts"])


def profiled(fn, path) -> list:
    """The `dogs.` spans of `fn()` under a CPU torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return spans_of(prof, path)


def inside(spans, parent) -> list:
    """Names of the spans within `parent`'s interval on its thread, in order."""
    return [e["name"] for e in spans if e is not parent and e["tid"] == parent["tid"]
            and parent["ts"] <= e["ts"] and e["ts"] + e["dur"] <= parent["ts"] + parent["dur"]]


def children(spans, parent) -> list:
    """The direct children's names, in order."""
    within = [e for e in spans if e["name"] in inside(spans, parent)]
    return [e["name"] for e in within if not any(e["name"] in inside(spans, o) for o in within if o is not e)]


def only(spans, name):
    (s,) = [e for e in spans if e["name"] == name]
    return s


def test_spans_are_one_null_context_without_a_profiler():
    null = trace.span("dogs.step")
    assert isinstance(null, contextlib.nullcontext)
    assert trace.span("dogs.eval.render") is null and trace.readback("bin_cull") is null
    with trace.span("dogs.step"):
        pass


def test_train_step_spans(tmp_path):
    run = train_step(scene("cpu"), "cpu")
    spans = profiled(lambda: run(0), tmp_path / "step.json")
    step = only(spans, "dogs.step")
    assert children(spans, step) == STAGES
    render = only(spans, "dogs.step.render")
    assert children(spans, render) == ["dogs.sync.step_background"] + RASTER
    assert children(spans, only(spans, "dogs.raster.bin")) == BIN_SYNCS
    assert children(spans, only(spans, "dogs.step.backward")) == [
        "dogs.sync.scale_reg_backward", "dogs.raster.blend_bwd", "dogs.raster.reduce"]
    assert children(spans, only(spans, "dogs.step.stats")) == ["dogs.sync.densify_stats_scale"]


def test_scaffold_step_spans(tmp_path):
    run = scaffold_step(scene("cpu"), "cpu")
    spans = profiled(lambda: run(0), tmp_path / "scaffold.json")
    assert children(spans, only(spans, "dogs.step")) == ["dogs.scaffold.prefilter", "dogs.scaffold.decode"] + STAGES
    assert children(spans, only(spans, "dogs.step.stats")) == ["dogs.sync.scaffold_stats_scale"]


def test_trainer_densify_nests_under_its_step(tmp_path):
    sc_ = scene("cpu")
    cfg = ttrainer.TrainerConfig(max_sh_degree=2, min_capacity=128, densify_start_iter=1, densify_end_iter=10,
                                 densification_interval=2, opacity_reset_interval=10000, spatial_lr_scale=1.0,
                                 profile_start_step=2, profile_num_steps=1, profile_dir=str(tmp_path))
    tr = ttrainer.GaussianSplatTrainer(sc_.cameras, sc_.images, sc_.points, sc_.colors, cfg, device="cpu")
    tr.train(2, log_every=0)
    events = json.loads((tmp_path / "trace_steps_2_2.json").read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("dogs.")),
                   key=lambda e: e["ts"])
    outer = only(spans, "dogs.trainer.step#2")
    assert children(spans, outer) == ["dogs.trainer.gt", "dogs.step", "dogs.trainer.densify"]
    assert children(spans, only(spans, "dogs.trainer.densify")) == ["dogs.sync.densify_need"]
    stats = trace.program_spans(events)
    assert stats["dogs.trainer.step"].count == 1 and stats["dogs.trainer.densify"].count == 1
    assert 0.0 < stats["dogs.trainer.step"].host_self_s < stats["dogs.trainer.step"].host_s


def test_evaluator_render_spans(tmp_path):
    sc_ = scene("cpu")
    ev = evaluator(sc_, "cpu")
    spans = profiled(lambda: ev.render(sc_.cameras[0]), tmp_path / "frame.json")
    frame = only(spans, "dogs.eval.render")
    assert children(spans, frame) == ["dogs.sync.eval_background"] + RASTER
    assert inside(spans, frame) == ["dogs.sync.eval_background", "dogs.raster.project", "dogs.raster.bin"] + \
        BIN_SYNCS + RASTER[2:]


def x(name, ts, dur, tid=1, cat="user_annotation", **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid, pid=1, args=args)


def test_program_spans_on_hand_built_events():
    events = [
        # main thread: two steps, each with a backward that waits on autograd's thread
        x("dogs.step", 0.0, 100.0),
        x("dogs.step.render", 0.0, 30.0),
        x("dogs.sync.bin_cull", 10.0, 5.0),
        x("dogs.step.backward", 40.0, 50.0),
        x("dogs.step", 200.0, 100.0),
        x("dogs.step.backward", 240.0, 50.0),
        # autograd's thread: the blend backward inside the main thread's backward
        x("dogs.raster.blend_bwd", 50.0, 20.0, tid=2),
        x("dogs.trainer.step#7", -10.0, 400.0, tid=1),
        # launches (runtime calls) and what they launched (matched by correlation)
        x("cudaLaunchKernel", 5.0, 1.0, cat="cuda_runtime", correlation=1),
        x("cudaLaunchKernel", 60.0, 1.0, cat="cuda_runtime", tid=2, correlation=2),
        x("cudaLaunchKernel", 80.0, 1.0, cat="cuda_runtime", correlation=3),
        x("cudaMemcpyAsync", 12.0, 1.0, cat="cuda_runtime", correlation=4),
        x("cudaLaunchKernel", 250.0, 1.0, cat="cuda_runtime", correlation=5),
        x("k_render", 1000.0, 4.0, cat="kernel", correlation=1),
        x("k_blend_bwd", 1010.0, 8.0, cat="kernel", correlation=2),
        x("k_vjp", 1020.0, 2.0, cat="kernel", correlation=3),
        x("Memcpy DtoH", 1030.0, 1.0, cat="gpu_memcpy", correlation=4),
        x("k_vjp", 1040.0, 2.0, cat="kernel", correlation=5),
        x("k_orphan", 1050.0, 3.0, cat="kernel", correlation=99),
        x("aten::add", 20.0, 1.0, cat="cpu_op"),
        x("dogs.step", 0.0, 100.0, cat="gpu_user_annotation"),
    ]
    got = trace.program_spans(events)
    assert sorted(got) == ["dogs.raster.blend_bwd", "dogs.step", "dogs.step.backward", "dogs.step.render",
                           "dogs.sync.bin_cull", "dogs.trainer.step"]
    us = 1e-6
    assert got["dogs.step"].count == 2 and got["dogs.step"].host_s == pytest.approx(200 * us)
    # self: the step less its render and backward on the main thread (not autograd's blend_bwd)
    assert got["dogs.step"].host_self_s == pytest.approx((100 - 30 - 50 + 100 - 50) * us)
    assert got["dogs.step.render"].host_self_s == pytest.approx(25 * us)
    assert got["dogs.trainer.step"].host_self_s == pytest.approx(200 * us)
    # device: at any depth, and self by the innermost span holding the launch, on any thread
    assert got["dogs.step"].device_s == pytest.approx(17 * us)
    assert got["dogs.trainer.step"].device_s == pytest.approx(17 * us)
    assert got["dogs.step.backward"].device_s == pytest.approx(12 * us)
    assert got["dogs.step.backward"].device_self_s == pytest.approx(4 * us)
    assert got["dogs.raster.blend_bwd"].device_self_s == pytest.approx(8 * us)
    assert got["dogs.step.render"].device_s == pytest.approx(5 * us)
    assert got["dogs.sync.bin_cull"].device_self_s == pytest.approx(1 * us)
    assert got["dogs.step.render"].device_self_s == pytest.approx(4 * us)
    assert got["dogs.step"].device_self_s == 0.0
    # kernel launches by runtime call, the memcpy not among them
    assert got["dogs.step"].launches == 4 and got["dogs.step.backward"].launches == 3
    assert got["dogs.raster.blend_bwd"].launches == 1 and got["dogs.step.render"].launches == 1


def sync_paths(dev):
    """One call each of the paths a cell takes a step or a frame through."""
    sc_ = scene(dev)
    step, sstep, ev = train_step(sc_, dev), scaffold_step(sc_, dev), evaluator(sc_, dev)
    return dict(train_step=lambda: step(0), scaffold_step=lambda: sstep(0), render=lambda: ev.render(sc_.cameras[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["train_step", "scaffold_step", "render"])
def test_every_host_sync_is_a_sync_span(path, tmp_path):
    """Under torch.cuda.set_sync_debug_mode("warn") one call of the path
    warns once a sync: as many warnings as `dogs.sync.*` spans. The first
    call (the kernels' build) runs outside the count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sync debug mode counts device syncs")
    run = sync_paths(torch.device("cuda", 0))[path]
    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            stack = traceback.extract_stack()[-6:-1]
            syncs.append(" <- ".join(f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno}" for f in reversed(stack)))

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            run()
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = [e["name"] for e in spans_of(prof, tmp_path / "sync.json") if e["name"].startswith("dogs.sync.")]
    assert len(syncs) == len(sites), f"sync warnings at {syncs}, sync spans {sites}"
