"""The reduction of a profiler trace and the per-layer arithmetic."""

from __future__ import annotations

import pytest

from benchmark import profiling


def _trace():
    return [
        {"ph": "X", "cat": "kernel", "name": "blend_forward_kernel(float const*)", "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 120.0, "dur": 60.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 400.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "blend_forward_kernel(float const*)", "ts": 600.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 170.0, "dur": 300.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 250.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 510.0, "dur": 80.0},
        {"ph": "i", "cat": "kernel", "name": "ignored instant", "ts": 0.0},
    ]


def test_reduce_trace():
    dev, busy, breakdown = profiling.reduce_trace(_trace())
    assert [d[0] for d in dev][:2] == ["blend_forward_kernel(float const*)", "elementwise"]
    # union: [100, 180) + [400, 500) + [600, 620) = 200 us
    assert busy == pytest.approx(200e-6)
    ops = dict((k, v) for k, v in breakdown["device_ops"])
    assert ops["blend_forward_kernel(float const*)"] == pytest.approx(70e-6)
    # gaps: 180-400 (midpoint 290: cudaStreamSynchronize inside aten::nonzero), 500-600 (550: aten::sort)
    assert breakdown["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(220e-6)],
                                      ["aten::sort", pytest.approx(100e-6)]]


def _obs(**kw):
    base = dict(spans={}, counts={}, kernels=[], window_s=0.0, busy_s=0.0)
    base.update(kw)
    return profiling.Observation(**base)


def test_idle_and_rooflines():
    dev, busy, _ = profiling.reduce_trace(_trace())
    obs = _obs(kernels=dev, window_s=800e-6, busy_s=busy, counts={"fwd": [10e-6, 4e-6]})
    assert profiling.idle_pct(obs) == pytest.approx(75.0)
    assert profiling.roofline_pct(obs, ("blend_forward_kernel",), "fwd") == pytest.approx(100 * 14 / 70)
    # a call without a kernel (or a kernel without a call) reads nothing
    assert profiling.roofline_pct(_obs(kernels=dev, counts={"fwd": [1e-6]}), ("blend_forward_kernel",), "fwd") is None
    assert profiling.idle_pct(_obs()) is None


def test_mfu_and_events():
    obs = _obs(counts={"step_flops": 67e9, "untraced_step_ms": 100.0}, spans={"densify": [(0.05, 0.03), (0.07, 0.03)]})
    assert profiling.mfu_pct(obs) == pytest.approx(1.0)
    frame = _obs(counts={"frame_flops": 67e9, "untraced_frame_ms": 50.0})
    assert profiling.mfu_pct(frame, "frame_flops", "untraced_frame_ms") == pytest.approx(2.0)
    assert profiling.mfu_pct(frame) is None
    assert profiling.event_ms(obs, "densify") == pytest.approx(30.0)
    assert profiling.event_ms(obs, "anchor") is None and profiling.mfu_pct(_obs()) is None
