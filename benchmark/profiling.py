"""What a `--trace 1` run records: host-clock spans that the traffic drivers
take around calls into the program, counts that the benchmark works out
from a run's inputs, and one `torch.profiler` segment over a steady part of
the window, reduced to device intervals, the busy time, the heaviest
device operations and the longest idle gaps with what the host was doing.

The per-layer metric files (benchmark/metrics/<name>.py) read an
`Observation` of these; the helpers here are the arithmetic they share.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import tempfile
import time

import torch

from benchmark import counts

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


@dataclasses.dataclass
class Observation:
    """What a traced run hands the metric readers: spans (name -> list of
    values), counts (name -> value), the profiled segment's device events
    (name, start us, duration us), its length and its busy seconds."""

    spans: dict
    counts: dict
    kernels: list
    window_s: float
    busy_s: float


class Tracer:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.spans: dict[str, list] = collections.defaultdict(list)
        self.counts: dict = {}
        self.kernels: list = []
        self.window_s = 0.0
        self.busy_s = 0.0
        self.breakdown: dict = {"device_ops": [], "idle_gaps": []}
        self._prof = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def segment(self):
        """Profile the block: the device is synchronized before and after,
        so the segment's length is the host clock between the two. The
        window runs on for as long as the segment took (the drivers leave it
        out of the window's clock)."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.window_s = time.perf_counter() - t0
            self._prof.stop()

    def reduce(self) -> None:
        """Read the profiled segment's trace (after the window: exporting it
        takes seconds)."""
        if self._prof is None:
            return
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = None
        self.kernels, self.busy_s, self.breakdown = reduce_trace(events)

    def observation(self) -> Observation:
        return Observation(dict(self.spans), dict(self.counts), self.kernels, self.window_s, self.busy_s)


def reduce_trace(events: list) -> tuple[list, float, dict]:
    """(device events (name, start us, duration us) by start, busy seconds
    as the union of their intervals, breakdown: the TOP device operations
    by total seconds and the TOP longest idle gaps between device
    intervals, each named by the innermost host event under its midpoint)."""
    dev = sorted((e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                 if e.get("ph") == "X" and e.get("cat") in GPU_CATS)
    dev.sort(key=lambda k: k[1])
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    merged: list[list[float]] = []
    for _, ts, dur in dev:
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ts + dur)
        else:
            merged.append([ts, ts + dur])
    busy = sum(b - a for a, b in merged) * 1e-6
    per_op = collections.Counter()
    for name, _, dur in dev:
        per_op[name[:160]] += dur * 1e-6
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])), reverse=True)[:TOP]
    idle = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        under = [h for h in host if h[0] <= mid <= h[1]]
        name = max(under, key=lambda h: h[0])[2] if under else "no host event"
        idle.append([name[:160], length * 1e-6])
    return dev, busy, {"device_ops": [[k, v] for k, v in per_op.most_common(TOP)], "idle_gaps": idle}


# ---- arithmetic the metric readers share ------------------------------------


def idle_pct(obs: Observation) -> float | None:
    if not obs.kernels or obs.window_s <= 0:
        return None
    return 100.0 * (1.0 - obs.busy_s / obs.window_s)


def roofline_pct(obs: Observation, prefixes: tuple, bound_key: str) -> float | None:
    """100 x the summed least times of the profiled calls (counts[bound_key],
    one per call, in call order) over the summed device times of the kernels
    whose names start with one of `prefixes`. None when there is nothing to
    read or the calls and the kernels do not pair up."""
    times = [dur for name, _, dur in obs.kernels if name.startswith(prefixes)]
    bounds = obs.counts.get(bound_key) or []
    if not times or len(times) != len(bounds):
        return None
    return 100.0 * sum(bounds) / (sum(times) * 1e-6)


def mfu_pct(obs: Observation, flops_key: str = "step_flops", ms_key: str = "untraced_step_ms") -> float | None:
    """100 x the step's (or frame's) counted flops over (its untraced time
    x the f32 peak)."""
    flops, ms = obs.counts.get(flops_key), obs.counts.get(ms_key)
    if not flops or not ms:
        return None
    return 100.0 * flops / (ms * 1e-3 * counts.PEAK_F32_FLOPS)


def event_ms(obs: Observation, name: str) -> float | None:
    """Mean over the events of (the synchronized host time of the call that
    ran the event) - (that of the plain call before it), in ms."""
    pairs = obs.spans.get(name) or []
    if not pairs:
        return None
    return 1e3 * sum(ev - plain for ev, plain in pairs) / len(pairs)
