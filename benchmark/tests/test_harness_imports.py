"""Nothing the harness loads is JAX or dogs_tpu (by whole top-level
name), and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = sorted((ROOT / "benchmark" / "reference").glob("*.py"))


def _loaded_after(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("names,found", [
    (["dogs_tpu_torch", "dogs_tpu_torch.raster", "jaxtyping", "flaxen.x"], []),
    (["dogs_tpu", "dogs_tpu.core.sh", "jax.numpy", "jaxlib", "flax"],
     ["dogs_tpu", "dogs_tpu.core.sh", "flax", "jax.numpy", "jaxlib"]),
])
def test_forbidden_by_whole_top_level_name(names, found):
    assert harness.forbidden_modules(names) == sorted(found)


def test_harness_loads_no_jax_nor_dogs_tpu():
    code = ("import benchmark.run, benchmark.harness, benchmark.calibrate, benchmark.profiling\n"
            "from benchmark import harness\n"
            "spec = harness.spec()\n"
            "[harness.driver(harness.traffic(w['traffic'])['driver']) for w in spec['workloads']]\n"
            "[harness.metric_reader(m['name']) for m in spec['per_layer']]\n")
    loaded = _loaded_after(code)
    assert harness.forbidden_modules(loaded) == []
    assert "dogs_tpu_torch" in loaded


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_source_imports_nothing_of_the_program(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("dogs_tpu_torch", "dogs_tpu", "jax"), (path.name, m)


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference.gs3d, benchmark.reference.scaffold, "
                           "benchmark.reference.loss, benchmark.counts, benchmark.scenes, benchmark.compare")
    assert not [m for m in loaded if m.split(".")[0] in ("dogs_tpu_torch", "dogs_tpu", "jax", "jaxlib", "flax")]
