"""Run one cell of the benchmark of dogs_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (BENCHMARK.json `workloads`) names a
configuration and a traffic mix; the mix names the driver that runs it
(benchmark/traffic/<driver>.py). The driver sets up the program from the
seed, drives its first steps for the correctness check, then runs the
measured window of `--seconds`; the benchmark then compares what the timed
path produced with its plain reference (benchmark/reference/). The last
line of standard output is the result as one JSON object; the compared
numbers and their limits are the last lines of standard error.

With `--trace 0` the metrics are the cell's end-to-end ones; with
`--trace 1` its per-layer ones (benchmark/metrics/<name>.py), read from
host spans, counts and a `torch.profiler` segment of the window.

It needs a CUDA device (as many as the cell asks for) and exits 1 without
one; it exits 1 too if any module of JAX or of dogs_tpu was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)  # import as the `benchmark` package, never its files as top-level modules


def _fail(msg: str) -> int:
    print(f"benchmark/run.py: {msg}", file=sys.stderr)
    return 1


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Kernel caches at fixed paths inside the checkout (the program builds
    # its own CUDA kernels into dogs_tpu_torch/_build/).
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
    # One core and one CPU thread: the host drives the card from one thread,
    # and a pool of spinning CPU threads on a shared host only adds noise
    # (set-up 13-14 s against 19-25 s, steps a little steadier, on the card).
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[len(cores) // 2]})
    import torch

    torch.set_num_threads(1)

    from benchmark import harness

    spec = harness.spec(ROOT)
    wl = harness.cell(spec, args.workload)
    if not torch.cuda.is_available():
        return _fail("no CUDA device (torch.cuda.is_available() is False); the benchmark measures the card only")
    if torch.cuda.device_count() < wl["chips"]:
        return _fail(f"{args.workload} needs {wl['chips']} CUDA devices, {torch.cuda.device_count()} present")
    try:
        import dogs_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program under test does not import: {e}")
    return run_cell(spec, wl, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)


def run_cell(spec: dict, wl: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             cfg: dict | None = None, traffic: dict | None = None, limits: dict | None = None) -> int:
    """Set up, measure, check and print one run of cell `wl` on `device`;
    the configuration, traffic and limits come from the cell's files unless
    given. Returns the exit code."""
    import torch

    from benchmark import harness, profiling

    traffic = traffic if traffic is not None else harness.traffic(wl["traffic"])
    cfg = cfg if cfg is not None else harness.config(spec, wl["config"], ROOT)
    limits = limits if limits is not None else harness.workload_file(wl["name"]).get("limits", {})
    meter = harness.PeakMeter(device)
    run = harness.driver(traffic["driver"]).build(cfg, traffic, seed, device, meter)
    tracer = profiling.Tracer(device) if trace else None
    res = run.window(seconds, tracer)
    meter.stop()
    t_window = time.perf_counter()
    if tracer is not None:
        tracer.reduce()
        run.count(tracer)
    t_count = time.perf_counter()
    checks = harness.checks_from(run.verify(), limits)
    print(f"phases: set-up {res['t0'] - t_start:.3f} s, window {t_window - res['t0']:.3f} s, counts "
          f"{t_count - t_window:.3f} s, reference and checks {time.perf_counter() - t_count:.3f} s",
          file=sys.stderr)
    correct = bool(checks) and all(c.ok for c in checks)

    if trace:
        obs = tracer.observation()
        metrics = {}
        for m in harness.metrics_of(spec, wl["name"], "per_layer"):
            value = harness.metric_reader(m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(res["e2e"], setup_s=res["t0"] - t_start, peak_mem_gib=meter.peak / 2**30)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in harness.metrics_of(spec, wl["name"], "end_to_end")}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=wl["chips"], memory_peak_bytes=int(meter.peak))
    if trace:
        dev.update(busy_s=tracer.busy_s, window_s=tracer.window_s)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark/run.py: modules of JAX or dogs_tpu were loaded: {bad}", file=sys.stderr)
        return 1
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    line = harness.result_line(correct, res["attempted"], res["failed"], metrics, dev, checks,
                               tracer.breakdown if trace else None)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
