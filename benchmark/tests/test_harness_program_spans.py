"""The program's `dogs.` spans (record_function ranges: `user_annotation`
events on the host, `gpu_user_annotation` ranges on the device's timeline)
move nothing the benchmark reads: every per-layer reader returns the same
value on a trace with and without them. Where no aten call was open, an idle
gap is named by the program span the host was in."""

from __future__ import annotations

import pytest

from benchmark import harness, profiling

SPEC = harness.spec()


def _events() -> list:
    return [
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::blend_forward_kernel(float const*)",
         "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::blend_backward_kernel(float const*)",
         "ts": 150.0, "dur": 40.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 400.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 900.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 170.0, "dur": 300.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 250.0, "dur": 100.0},
    ]


def _spans() -> list:
    """A step, its stages, a host sync and a host event with no aten call
    inside (500-900: numpy on the host)."""
    ann = [("dogs.trainer.step#7", 0.0, 1000.0), ("dogs.step", 10.0, 480.0), ("dogs.step.render", 10.0, 150.0),
           ("dogs.sync.bin_cull", 160.0, 320.0), ("dogs.scaffold.anchor_event", 500.0, 400.0)]
    out = []
    for name, ts, dur in ann:
        out.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1})
        out.append({"ph": "X", "cat": "gpu_user_annotation", "name": name, "ts": ts + 90.0, "dur": dur, "tid": 7})
    return out


def _obs(events: list) -> profiling.Observation:
    kernels, busy, _ = profiling.reduce_trace(events)
    counts = {"blend_forward_bound_s": [10e-6], "blend_backward_bound_s": [6e-6], "step_flops": 67e9,
              "untraced_step_ms": 100.0, "frame_flops": 67e9, "untraced_frame_ms": 50.0}
    spans = {"densify": [(0.05, 0.03)], "anchor": [(1.5, 0.07)], "enqueue": [0.02, 0.022]}
    return profiling.Observation(spans, counts, kernels, 1100e-6, busy)


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_readers_read_the_same_with_program_spans(name):
    reader = harness.metric_reader(name)
    plain, spanned = _obs(_events()), _obs(_events() + _spans())
    assert plain.kernels == spanned.kernels and plain.busy_s == spanned.busy_s
    value = reader.read(plain)
    assert value is not None
    assert reader.read(spanned) == value


def test_idle_gaps_are_named_by_program_spans():
    _, _, plain = profiling.reduce_trace(_events())
    _, _, spanned = profiling.reduce_trace(_events() + _spans())
    assert plain["device_ops"] == spanned["device_ops"]
    # gaps 500-900 (midpoint 700: the anchor event, no aten call) and
    # 190-400 (295: the sync inside aten::nonzero, the innermost call)
    assert plain["idle_gaps"] == [["no host event", pytest.approx(400e-6)],
                                  ["cudaStreamSynchronize", pytest.approx(210e-6)]]
    assert spanned["idle_gaps"] == [["dogs.scaffold.anchor_event", pytest.approx(400e-6)],
                                    ["cudaStreamSynchronize", pytest.approx(210e-6)]]
