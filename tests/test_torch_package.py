"""Import hygiene of dogs_tpu_torch and its no-fallback rule.

Each check runs in a fresh interpreter: this test process has JAX loaded
already (tests/conftest.py), and the machine with the card has no JAX.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def run_python(code: str, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def test_every_module_imports_without_jax():
    proc = run_python(
        "import importlib, pkgutil, sys\n"
        "import dogs_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dogs_tpu_torch.__path__, 'dogs_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 20, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dogs_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names), 'modules')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert "modules" in proc.stdout


def test_kernel_entry_point_raises_on_cpu_and_render_takes_plain_path():
    proc = run_python(
        "import torch\n"
        "from dogs_tpu_torch.core import look_at_camera, params_from_numpy\n"
        "from dogs_tpu_torch.data import synthetic\n"
        "from dogs_tpu_torch.raster import blend\n"
        "from dogs_tpu_torch.raster.tiled import render_tiled\n"
        "ent = torch.zeros((4, blend.ENT_WIDTH))\n"
        "starts = torch.tensor([0, 2, 4], dtype=torch.int32)\n"
        "try:\n"
        "    blend.blend_forward(ent, starts, 1, 2, 32, 16)\n"
        "except ValueError as e:\n"
        "    assert 'CUDA' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('blend_forward ran on CPU tensors')\n"
        "out = render_tiled(params_from_numpy(synthetic.random_scene_arrays()),\n"
        "                   look_at_camera(**synthetic.RANDOM_SCENE_VIEW), active_sh_degree=2)\n"
        "assert out.image.shape == (56, 72, 3) and bool(torch.isfinite(out.image).all())\n"
        "assert blend.blend_forward.launches == 0\n"
        "assert blend.build_kernel.cache_info().currsize == 0  # nothing was built\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Run alone, outside the repo: it must fail and print no result line.
    (Without a card it stops before importing the package at all.)"""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
