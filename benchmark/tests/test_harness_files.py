"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import re

import pytest

from benchmark import harness

SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
PER_LAYER = [m["name"] for m in SPEC["per_layer"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lengths():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in SPEC["end_to_end"]] + PER_LAYER
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"] and "\t" not in entry["why"]
    assert entry["file"].startswith("benchmark/")
    cfg = harness.config(SPEC, name)
    assert cfg["name"] == name
    assert set(entry["reduced"]) == set(cfg["reduced"])
    for key in entry["reduced"]:
        assert not key.endswith(("_dim", "_rank")) and NAME.match(key)
    assert any(w["config"] == name for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    wl = harness.cell(SPEC, name)
    traffic = harness.traffic(wl["traffic"])
    driver = harness.driver(traffic["driver"])
    assert callable(driver.build)
    limits = harness.workload_file(name)["limits"]
    for k, v in limits.items():
        assert v["limit"] is not None and v["lower"] <= v["limit"], k
        assert v.get("upper") is None or v["limit"] < v["upper"], k
    e2e = harness.metrics_of(SPEC, name, "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.metrics_of(SPEC, name, "per_layer")


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader(name):
    m = next(m for m in SPEC["per_layer"] if m["name"] == name)
    reader = harness.metric_reader(name)
    assert reader.MOVES == m["moves"]
    assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
    for cell in m["workloads"]:
        assert cell in CELLS
        assert m["moves"] in [e["name"] for e in harness.metrics_of(SPEC, cell, "end_to_end")]
    assert 1 <= len(m["layer"]) <= 200


def test_every_layer_is_in_perf_md():
    """A layer is named as PERF.md's list of layers names it, letter for
    letter, so that metrics of one layer give one name."""
    perf = (harness.ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]
