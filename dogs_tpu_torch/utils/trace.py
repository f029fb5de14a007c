"""Spans on the profiler's clock.

`span(name)` opens a `torch.profiler.record_function` range while a
profiler runs (the trainer's own hook, `trainer.profile.*`, or any caller's
`torch.profiler.profile`); with none running it returns one shared null
context after one check of the profiler's state (about a microsecond on the
host), recording and allocating nothing. The ranges land in the profiler's
own trace, on the clock of its device events, so each device operation can
be placed under the span that was open on the host when it was launched,
and each idle gap of the device under the span the host was in
(`program_spans`).

Names start with `dogs.`; a step number rides after `#`, as torch's own
`ProfilerStep#N`. `readback(site)` is the span `dogs.sync.<site>` around a
line on a step's or a frame's path that makes the host wait for the device
(a read of a device value, a boolean index, a blocking copy from host
memory): each such span is one host sync, and its host time is the wait.

The spans, outermost first:

- `dogs.trainer.step#<n>`: one iteration of `GaussianSplatTrainer.train`
  or `ScaffoldGSTrainer.train`, with `dogs.trainer.gt`,
  `dogs.trainer.densify`, `dogs.trainer.validate`, `dogs.trainer.checkpoint`
  and `dogs.scaffold.anchor_event` inside;
- `dogs.step`: one `make_train_step` or Scaffold-GS step, whose stages are
  `dogs.scaffold.prefilter` and `dogs.scaffold.decode` (Scaffold-GS), then
  `dogs.step.render`, `dogs.step.loss`, `dogs.step.backward`,
  `dogs.step.adam` and `dogs.step.stats`;
- `dogs.eval.render`: one `GaussianSplatEvaluator.render`;
- in `render_tiled`: `dogs.raster.project` (on the card the preprocess
  forward kernel, which writes the entry matrix too), `dogs.raster.bin`,
  `dogs.raster.entries` (the plain path's entry matrix),
  `dogs.raster.blend_fwd` (K1), and in the backward, on autograd's thread,
  `dogs.raster.blend_bwd` (K2), `dogs.raster.reduce` (K3) and
  `dogs.raster.project_bwd` (the preprocess backward kernel);
- `dogs.sync.<site>`: binning's `bin_expand`, `bin_cull`, `bin_truncated`,
  the scale regularizer's backward (`scale_reg_backward`: `torch.prod`'s
  VJP reads back its count of zeros), and the blocking copies and reads of
  the step, the render and the trainer loop;
- the block trainer over ranks (parallel/master.py, parallel/admm.py):
  `dogs.admm.command` (rank 0 sends one command to every worker),
  `dogs.admm.fusion`, `dogs.admm.consensus` with `.zsum`, `.allreduce`,
  `.dual` and `.residuals` inside, `dogs.admm.penalty` inside
  `dogs.step.loss`, and the read of the round's residuals,
  `dogs.sync.admm_residuals`.

`counter(name, value)` marks a number of the program's in a profiler's
trace as the empty span `dogs.count.<name>#<value>`: each consensus round
over ranks marks `admm.shared_rows` (the rows that two or more blocks hold)
and `admm.allreduce_bytes` (the bytes it all-reduces).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

PREFIX = "dogs."
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A `record_function(name)` range while a profiler runs, else a shared
    null context."""
    if not _profiling():
        return _NULL
    return torch.profiler.record_function(name)


def counter(name: str, value: float) -> None:
    """The empty span `dogs.count.<name>#<value>` while a profiler runs."""
    if _profiling():
        with torch.profiler.record_function(f"{PREFIX}count.{name}#{value}"):
            pass


def readback(site: str):
    """The span `dogs.sync.<site>` around one host wait for the device."""
    if not _profiling():
        return _NULL
    return torch.profiler.record_function(PREFIX + "sync." + site)


def readback_in_backward(t: torch.Tensor, site: str) -> torch.Tensor:
    """`t`, whose autograd node (the VJP of the op that made it, run later
    on autograd's thread) runs in the span `dogs.sync.<site>` while a
    profiler runs: for an op whose backward waits for the device, as
    `torch.prod`'s reads its count of zeros back."""
    if _profiling() and t.grad_fn is not None:
        rf = torch.profiler.record_function(PREFIX + "sync." + site)
        t.grad_fn.register_prehook(lambda _: rf.__enter__() and None)
        t.grad_fn.register_hook(lambda *_: rf.__exit__(None, None, None))
    return t


@dataclasses.dataclass
class SpanStats:
    """One span name's totals over a trace: how many, host seconds (self:
    less the child `dogs.` spans on its thread), device seconds of the
    operations launched under it at any depth (self: those whose innermost
    span it is), and the kernel launches under it."""

    count: int = 0
    host_s: float = 0.0
    host_self_s: float = 0.0
    device_s: float = 0.0
    device_self_s: float = 0.0
    launches: int = 0


def program_spans(events: list) -> dict[str, SpanStats]:
    """Totals by span name (cut at `#`) of the `dogs.` spans in a Chrome
    trace's events (`traceEvents` of `export_chrome_trace`).

    A device operation is matched to the runtime call that launched it by
    the trace's `args.correlation`, and belongs to every span whose interval
    holds that launch, on any thread: the backward's spans open on
    autograd's device thread while the step's `dogs.step.backward` waits on
    the caller's. Its innermost span is the one opened last."""
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("tid"),
                     e["name"].split("#", 1)[0]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX)),
                   key=lambda s: (s[0], -s[1]))  # an outer span before the inner one it starts with
    out: dict[str, SpanStats] = {}
    for start, end, _, name in spans:
        st = out.setdefault(name, SpanStats())
        st.count += 1
        st.host_s += (end - start) * 1e-6
        st.host_self_s += (end - start) * 1e-6
    # Host self time: spans on one thread nest, so a span's parent is the
    # innermost earlier span on its thread that is still open.
    stacks: dict = {}
    for start, end, tid, name in spans:
        stack = stacks.setdefault(tid, [])
        while stack and stack[-1][1] <= start:
            stack.pop()
        if stack:
            out[stack[-1][3]].host_self_s -= (end - start) * 1e-6
        stack.append((start, end, tid, name))

    launched = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = e
    points = []  # (host time, device seconds or None for a launch)
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in DEVICE_CATS:
            call = launched.get(e.get("args", {}).get("correlation"))
            if call is not None:
                points.append((float(call["ts"]), float(e.get("dur", 0.0)) * 1e-6))
        elif e.get("cat") in RUNTIME_CATS and e.get("name") in LAUNCHES:
            points.append((float(e["ts"]), None))
    points.sort(key=lambda p: p[0])
    active: list = []
    i = 0
    for t, dev_s in points:
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= t]
        if not active:
            continue
        for name in {s[3] for s in active}:
            if dev_s is None:
                out[name].launches += 1
            else:
                out[name].device_s += dev_s
        if dev_s is not None:
            out[max(active, key=lambda s: (s[0], -s[1]))[3]].device_self_s += dev_s
    return out
