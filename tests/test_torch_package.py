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
    """No JAX, no PyYAML, no PIL, no imageio and nothing of dogs_tpu, by
    module name and by file: a module loaded from a dogs_tpu/ file under
    another name is caught too. No source file of the port imports imageio;
    PIL is imported only by data/dataset.py, inside the call, for a JPEG
    process the port's decoder rejects (progressive, CMYK) or a file that
    is neither PNG nor JPEG."""
    proc = run_python(
        "import importlib, pkgutil, sys\n"
        "from pathlib import Path\n"
        "import dogs_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(dogs_tpu_torch.__path__, 'dogs_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 48, names\n"
        "new = {'dogs_tpu_torch.data.colmap', 'dogs_tpu_torch.data.reader', 'dogs_tpu_torch.fields.appearance',\n"
        "       'dogs_tpu_torch.data.blocks', 'dogs_tpu_torch.data.splitter', 'dogs_tpu_torch.preprocess',\n"
        "       'dogs_tpu_torch.parallel.admm', 'dogs_tpu_torch.parallel.master', 'dogs_tpu_torch.train_admm',\n"
        "       'dogs_tpu_torch.fields.scaffold', 'dogs_tpu_torch.bench'}\n"
        "assert new <= set(names), names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'dogs_tpu', 'yaml', 'PIL', 'imageio'))\n"
        "assert not bad, bad\n"
        f"ref = Path({str(REPO / 'dogs_tpu')!r})\n"
        "files = {n: Path(getattr(m, '__file__', None) or '/').resolve() for n, m in list(sys.modules.items())}\n"
        "loaded = sorted(n for n, f in files.items() if f.is_relative_to(ref))\n"
        "assert not loaded, loaded\n"
        "print(len(names), 'modules')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert "modules" in proc.stdout
    imports = {}
    for path in sorted((REPO / "dogs_tpu_torch").rglob("*.py")):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and words[1].split(".")[0] in ("PIL", "imageio"):
                imports.setdefault(str(path.relative_to(REPO)), []).append(line.strip())
    assert imports == {"dogs_tpu_torch/data/dataset.py": ["from PIL import Image"]}, imports


def test_every_device_parameter_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU."""
    import importlib
    import inspect
    import pkgutil

    import dogs_tpu_torch

    found = []
    for info in pkgutil.walk_packages(dogs_tpu_torch.__path__, "dogs_tpu_torch."):
        module = importlib.import_module(info.name)
        for name, obj in vars(module).items():
            if getattr(obj, "__module__", None) != module.__name__:
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                fns = [(f"{name}.{m}", getattr(f, "__func__", f)) for m, f in vars(obj).items()
                       if inspect.isfunction(getattr(f, "__func__", f))]  # classmethods too
            for qual, fn in fns:
                param = inspect.signature(fn).parameters.get("device")
                if param is None:
                    continue
                where = f"{module.__name__}.{qual}"
                if param.default is inspect.Parameter.empty:
                    assert qual.startswith("_"), f"{where}: public, with no default device"
                    continue
                assert param.default == "cuda", f"{where}: device defaults to {param.default!r}"
                found.append(where)
    assert len(found) >= 14, found
    admm_entry_points = {"dogs_tpu_torch.parallel.master.MasterTrainer.__init__",
                         "dogs_tpu_torch.parallel.master.MasterTrainer.from_manifests",
                         "dogs_tpu_torch.parallel.master.load_fused_from_checkpoint",
                         "dogs_tpu_torch.preprocess.synthetic_block_scene",
                         "dogs_tpu_torch.train_admm.load_val_split"}
    assert admm_entry_points <= set(found), sorted(admm_entry_points - set(found))
    scaffold_entry_points = {f"dogs_tpu_torch.fields.scaffold.{name}" for name in (
        "ScaffoldGSTrainer.__init__", "init_scaffold", "scaffold_params_from_numpy", "scaffold_state_from_arrays")}
    assert scaffold_entry_points <= set(found), sorted(scaffold_entry_points - set(found))


def test_kernel_entry_point_raises_on_cpu_and_render_takes_plain_path():
    proc = run_python(
        "import torch\n"
        "from dogs_tpu_torch.core import look_at_camera, params_from_numpy\n"
        "from dogs_tpu_torch.data import synthetic\n"
        "from dogs_tpu_torch.raster import blend\n"
        "from dogs_tpu_torch.raster.tiled import render_tiled\n"
        "ent = torch.zeros((4, blend.ENT_WIDTH))\n"
        "idx = torch.arange(4, dtype=torch.int32)\n"
        "starts = torch.tensor([0, 2, 4], dtype=torch.int32)\n"
        "try:\n"
        "    blend.blend_forward(ent, idx, starts, 1, 2, 32, 16)\n"
        "except ValueError as e:\n"
        "    assert 'CUDA' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('blend_forward ran on CPU tensors')\n"
        "out = render_tiled(params_from_numpy(synthetic.random_scene_arrays(), 'cpu'),\n"
        "                   look_at_camera(**synthetic.RANDOM_SCENE_VIEW, device='cpu'),\n"
        "                   active_sh_degree=2)\n"
        "assert out.image.shape == (56, 72, 3) and bool(torch.isfinite(out.image).all())\n"
        "from dogs_tpu_torch import kernels\n"
        "assert not kernels.launches, kernels.launches  # no kernel launched\n"
        "assert kernels.build_all.cache_info().currsize == 0  # nothing was built\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_backward_kernels_raise_on_cpu_and_render_backward_takes_plain_path():
    proc = run_python(
        "import torch\n"
        "from dogs_tpu_torch import kernels\n"
        "from dogs_tpu_torch.core import look_at_camera, params_from_numpy\n"
        "from dogs_tpu_torch.data import synthetic\n"
        "from dogs_tpu_torch.raster import blend, reduce\n"
        "from dogs_tpu_torch.raster.tiled import render_tiled\n"
        "ent = torch.zeros((4, blend.ENT_WIDTH))\n"
        "idx = torch.arange(4, dtype=torch.int32)\n"
        "starts = torch.tensor([0, 2, 4], dtype=torch.int32)\n"
        "cot = torch.zeros((2, blend.COT_ROWS, 256))\n"
        "calls = [lambda: blend.blend_backward(ent, idx, starts, cot, 1, 2, 32, 16),\n"
        "         lambda: reduce.sorted_segment_sum(ent, idx, torch.zeros(4, dtype=torch.int32), 3)]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except ValueError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('a kernel wrapper ran on CPU tensors')\n"
        "params = params_from_numpy(synthetic.random_scene_arrays(), 'cpu')\n"
        "out = render_tiled(params, look_at_camera(**synthetic.RANDOM_SCENE_VIEW, device='cpu'),\n"
        "                   active_sh_degree=2)\n"
        "grads = torch.autograd.grad(out.image.sum(), list(params.parameters()))\n"
        "assert all(bool(torch.isfinite(g).all()) for g in grads)\n"
        "assert not kernels.launches, kernels.launches  # no kernel launched\n"
        "assert kernels.build_all.cache_info().currsize == 0  # nothing was built\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_serving_path_builds_no_graph(tmp_path):
    """render_tiled is differentiable and the parameters require grad; the
    serving callers (the evaluator and make_scene) run under no_grad."""
    import numpy as np
    import torch

    from dogs_tpu_torch.core import params_from_numpy
    from dogs_tpu_torch.data import synthetic
    from dogs_tpu_torch.eval.evaluator import EvalConfig, GaussianSplatEvaluator
    from dogs_tpu_torch.fields.model import GaussianModelState

    scene = synthetic.make_scene(n_gaussians=24, n_cams=2, width=40, height=32, seed=1, device="cpu")
    assert not any(img.requires_grad for img in scene.images)
    params = params_from_numpy(synthetic.gt_params_arrays(24, seed=1), "cpu")
    assert params.xyz.requires_grad
    n = params.capacity
    model = GaussianModelState(params, torch.ones(n, dtype=torch.bool), torch.zeros(n),
                               torch.zeros(n), torch.zeros(n))
    ev = GaussianSplatEvaluator(model, cfg=EvalConfig(output_dir=str(tmp_path), save_images=False,
                                                      active_sh_degree=2))
    img = ev.render(scene.cameras[0])
    assert not img.requires_grad and img.grad_fn is None
    metrics = ev.eval(scene.cameras, [np.asarray(i) for i in scene.images])
    assert metrics["mean"]["psnr"] > 20.0


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
