"""The per-Gaussian preprocess kernels' arithmetic on the host, and the code
around them.

csrc/preprocess.cuh holds what one thread of the forward and backward
kernels computes for one slot; compiled here with g++ (-DDOGS_PREPROCESS_HOST:
plain loops over the slots) it is held against autograd through the plain
`project_gaussians` + `entry_matrix` over SH degrees 0-4, antialiasing, the
scale modifier, alive, both offsets, a colour override and the camera's
gradient, on scenes with slots behind the near plane and past the EWA clamp.
Then `_Preprocess`'s wiring on CPU tensors, its two launches replaced by
their plain versions, and `render_tiled`'s plain path. The kernels themselves run in tests/test_torch_cuda.py, which
imports CASES and case_inputs from here (no JAX in this file).
"""

import ctypes
import dataclasses
import subprocess

import numpy as np
import pytest
import torch

from dogs_tpu_torch import kernels
from dogs_tpu_torch.core import look_at_camera, params_from_numpy
from dogs_tpu_torch.core.gaussians import PARAM_NAMES
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.raster import preprocess, tiled
from dogs_tpu_torch.raster.binning import build_tile_bins
from dogs_tpu_torch.raster.projection import entry_matrix, project_gaussians
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled

# case -> stored SH degree, active degree and options
CASES = {
    "sh0_of_3": dict(max_deg=3, deg=0),
    "sh1_antialiasing": dict(max_deg=3, deg=1, antialiasing=True),
    "sh2_scale_modifier": dict(max_deg=2, deg=2, scale_modifier=0.7),
    "sh3_alive_offsets": dict(max_deg=3, deg=3, alive=True, offsets=True),
    "sh3_of_4_antialiasing": dict(max_deg=4, deg=3, antialiasing=True, offsets=True),
    "sh4_alive": dict(max_deg=4, deg=4, alive=True),
    "color_override": dict(max_deg=0, deg=0, override=True, alive=True, offsets=True, antialiasing=True),
}
ENT_TOL = 1e-5  # forward, per column, relative to the column's largest value
GRAD_TOL = 2e-5  # backward, per input, relative to its largest gradient


def case_inputs(case: str, dev, n: int = 3000) -> preprocess.Inputs:
    """One case's inputs: synthetic.edge_scene_arrays at RANDOM_SCENE_VIEW,
    random offsets and colours (some negative) drawn with numpy."""
    c = CASES[case]
    seed = list(CASES).index(case)
    rng = np.random.RandomState(100 + seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    arrays = synthetic.edge_scene_arrays(n, seed=seed, max_sh_degree=c["max_deg"])
    return preprocess.Inputs(
        **{k: t(v) for k, v in arrays.items()},
        color_override=t(rng.uniform(-0.2, 1.0, (n, 3))) if c.get("override") else None,
        means2d_offset=t(rng.randn(n, 2) * 0.3) if c.get("offsets") else None,
        invd_offset=t(rng.randn(n) * 0.1) if c.get("offsets") else None,
        camera=look_at_camera(**synthetic.RANDOM_SCENE_VIEW, device=dev),
        alive=torch.as_tensor(rng.rand(n) > 0.1, device=dev) if c.get("alive") else None,
        degree=c["deg"], antialiasing=c.get("antialiasing", False), scale_modifier=c.get("scale_modifier", 1.0),
    )


def cotangent(radius: torch.Tensor, seed: int) -> torch.Tensor:
    """A random (N, 16) entry cotangent, zero on culled rows: the segment
    sum gives a slot no tile reads a zero row."""
    g = torch.Generator(device=radius.device).manual_seed(seed)
    return torch.randn((radius.shape[0], 16), generator=g, device=radius.device) * (radius > 0)[:, None]


def present(x: preprocess.Inputs) -> list[bool]:
    """`needs` asking for every input the case has."""
    return [x.tensor(k) is not None for k in preprocess.GRAD_NAMES]


def assert_columns_close(got, want, tol, what):
    for c in range(want.shape[1]):
        scale = float(want[:, c].abs().max())
        torch.testing.assert_close(got[:, c], want[:, c], rtol=tol, atol=tol * scale,
                                   msg=lambda m: f"{what} column {c}: {m}")


def assert_grads_close(got, want, tol):
    for name, a, b in zip(preprocess.GRAD_NAMES, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=0, atol=tol * scale + 1e-30, msg=lambda m: f"{name}: {m}")


# ---- the kernels' arithmetic, built for the host ----------------------------


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/preprocess.cuh's host loops, compiled with g++ (no FMA
    contraction on x86-64 without -march, as the kernels' -fmad=false)."""
    d = tmp_path_factory.mktemp("preprocess_host")
    src = d / "preprocess_host.cpp"
    src.write_text(f'#include "{kernels.CSRC / "preprocess.cuh"}"\n')
    lib_path = d / "preprocess_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-DDOGS_PREPROCESS_HOST",
                    "-o", str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.dogs_preprocess_forward_host.argtypes = [ctypes.POINTER(preprocess.KernelArgs), ctypes.c_void_p,
                                                 ctypes.c_void_p]
    lib.dogs_preprocess_backward_host.argtypes = [ctypes.POINTER(preprocess.KernelArgs),
                                                  ctypes.POINTER(preprocess.KernelGrads)]
    return lib


def host_forward(lib, x):
    x = preprocess.contiguous(x)
    n = x.xyz.shape[0]
    ent, radius = torch.empty((n, 16)), torch.empty((n,))
    args = preprocess.kernel_args(x)
    assert lib.dogs_preprocess_forward_host(ctypes.byref(args), ent.data_ptr(), radius.data_ptr()) == 0
    return ent, radius


def host_backward(lib, x, d_ent, radius, needs):
    """The host loops with `preprocess_backward`'s choice of outputs; the
    camera's term summed in slot order."""
    x = preprocess.contiguous(x)
    want = dict(zip(preprocess.GRAD_NAMES, needs))
    if x.color_override is not None:
        want["feat_dc"] = want["feat_rest"] = False
    else:
        want["color_override"] = False
    out = {k: torch.full_like(x.tensor(k), float("nan")) if want[k] and x.tensor(k) is not None else None
           for k in preprocess.SLOTS}
    cam = torch.full((12,), float("nan")) if want["R"] or want["t"] else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    grads = preprocess.KernelGrads(d_ent.data_ptr(), radius.data_ptr(), *(ptr(out[k]) for k in preprocess.SLOTS),
                                   ptr(cam))
    args = preprocess.kernel_args(x)
    assert lib.dogs_preprocess_backward_host(ctypes.byref(args), ctypes.byref(grads)) == 0
    return (*(out[k] for k in preprocess.SLOTS), cam[:9].view(3, 3) if cam is not None and want["R"] else None,
            cam[9:] if cam is not None and want["t"] else None)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_forward_arithmetic_matches_plain(host, case):
    x = case_inputs(case, "cpu")
    ent, radius = host_forward(host, x)
    want_ent, want_radius = preprocess.preprocess_forward_reference(x)
    culled = want_radius == 0
    assert 0 < int(culled.sum()) < culled.numel() // 2
    assert torch.equal(radius, want_radius)
    assert_columns_close(ent, want_ent, ENT_TOL, case)
    assert not ent[:, 11:].any() and torch.equal(ent[culled, 8], want_ent[culled, 8])


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_backward_arithmetic_matches_autograd(host, case):
    """Every input's gradient, the camera's R and t among them (pose
    refinement), against autograd through the plain forward."""
    x = case_inputs(case, "cpu")
    _, radius = preprocess.preprocess_forward_reference(x)
    d_ent = cotangent(radius, seed=1)
    needs = present(x)
    got = host_backward(host, x, d_ent, radius, needs)
    want = preprocess.preprocess_backward_reference(x, d_ent, radius, needs)
    assert_grads_close(got, want, GRAD_TOL)
    culled = radius == 0
    for name, g in zip(preprocess.GRAD_NAMES, got):
        if g is not None and name in ("xyz", "log_scale", "quat", "logit_opacity", "feat_rest", "color_override"):
            assert not g[culled].any(), name


def test_kernel_backward_writes_only_what_is_asked(host):
    """LightGaussian's importance render asks for the inverse-depth offset
    alone: it gets d_ent's column 9 on every slot, and nothing else is
    written."""
    x = case_inputs("sh3_alive_offsets", "cpu")
    _, radius = preprocess.preprocess_forward_reference(x)
    d_ent = cotangent(radius, seed=2)
    needs = [k == "invd_offset" for k in preprocess.GRAD_NAMES]
    got = dict(zip(preprocess.GRAD_NAMES, host_backward(host, x, d_ent, radius, needs)))
    assert torch.equal(got.pop("invd_offset"), d_ent[:, 9])
    assert all(v is None for v in got.values())
    want = preprocess.preprocess_backward_reference(x, d_ent, radius, needs)
    assert torch.equal(want[preprocess.GRAD_NAMES.index("invd_offset")], d_ent[:, 9])


def test_kernel_backward_zeroes_the_inactive_sh_rows(host):
    """At degree 1 of 3 the rows of degrees 2 and 3 get zeros, as
    `features`' cat and eval_sh's slices give them."""
    x = case_inputs("sh1_antialiasing", "cpu")
    _, radius = preprocess.preprocess_forward_reference(x)
    d_rest = host_backward(host, x, cotangent(radius, seed=3), radius, present(x))[5]
    assert d_rest[:, :3].abs().max() > 0 and not d_rest[:, 3:].any()


# ---- _Preprocess, its launches replaced by their plain versions ------------


@pytest.fixture
def plain_launches(monkeypatch):
    """`_Preprocess` with `preprocess_forward` and `preprocess_backward`
    replaced by their plain versions, so that its wiring (what it saves,
    which gradients it asks for, what it records) runs on CPU tensors. The
    kernels themselves run in tests/test_torch_cuda.py."""
    monkeypatch.setattr(preprocess, "preprocess_forward", preprocess.preprocess_forward_reference)
    monkeypatch.setattr(preprocess, "preprocess_backward", preprocess.preprocess_backward_reference)


def scene_params(case: str, requires_grad: bool = True):
    x = case_inputs(case, "cpu", n=400)
    params = params_from_numpy({k: x.tensor(k).numpy() for k in PARAM_NAMES}, "cpu")
    params.requires_grad_(requires_grad)
    return x, params


@pytest.mark.parametrize("case", ["sh3_alive_offsets", "color_override"])
def test_function_gradients_equal_plain_autograd(case, plain_launches):
    """`preprocess` (its launches the plain versions) gives the entry
    matrix and every gradient, the camera's included, bit for bit as
    autograd through `project_gaussians` + `entry_matrix`."""
    x, params = scene_params(case)
    grads = {}
    for path in ("function", "plain"):
        offs = {k: None if x.tensor(k) is None else x.tensor(k).clone().requires_grad_(True)
                for k in ("means2d_offset", "invd_offset", "color_override")}
        R, t = x.camera.R.clone().requires_grad_(True), x.camera.t.clone().requires_grad_(True)
        cam = dataclasses.replace(x.camera, R=R, t=t)
        kw = dict(alive=x.alive, active_sh_degree=x.degree, antialiasing=x.antialiasing,
                  means2d_offset=offs["means2d_offset"], color_override=offs["color_override"])
        if path == "function":
            ent, radius = preprocess.preprocess(params, cam, invd_offset=offs["invd_offset"], **kw)
        else:
            proj = project_gaussians(params, cam, **kw)
            ent, radius = entry_matrix(proj, offs["invd_offset"]), proj.radius
        d_ent = cotangent(radius.detach(), seed=4)
        read = [k for k in PARAM_NAMES if x.color_override is None or k not in ("feat_dc", "feat_rest")]
        leaves = [getattr(params, k) for k in read] + [v for v in offs.values() if v is not None] + [R, t]
        grads[path] = (ent.detach(), radius, torch.autograd.grad(ent, leaves, d_ent))
    (e1, r1, g1), (e2, r2, g2) = grads["function"], grads["plain"]
    assert torch.equal(e1, e2) and torch.equal(r1, r2) and not r1.requires_grad
    assert len(g1) == len(g2) and all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_function_records_nothing_under_no_grad(plain_launches):
    """Evaluator frames run under no_grad: no graph, no saved tensors."""
    _, params = scene_params("sh3_alive_offsets")
    cam = look_at_camera(**synthetic.RANDOM_SCENE_VIEW, device="cpu")
    with torch.no_grad():
        ent, radius = preprocess.preprocess(params, cam, active_sh_degree=3)
    assert ent.grad_fn is None and not ent.requires_grad and not radius.requires_grad
    ent, _ = preprocess.preprocess(params, cam, active_sh_degree=3)
    assert ent.grad_fn is not None


def test_function_saves_only_its_inputs_and_the_radii(plain_launches):
    """The backward recomputes the forward: the node keeps the leaves it
    was given and the (N,) radii, no (N, k) intermediate."""
    x, params = scene_params("sh3_alive_offsets")
    offset = x.means2d_offset.clone().requires_grad_(True)
    ent, radius = preprocess.preprocess(params, x.camera, alive=x.alive, active_sh_degree=3, means2d_offset=offset)
    inputs = [getattr(params, k) for k in PARAM_NAMES] + [offset, x.camera.R, x.camera.t]
    saved = [t for t in ent.grad_fn.saved_tensors if t is not None]
    assert len(saved) == len(inputs) + 1
    for t in saved:
        assert any(t.data_ptr() == s.data_ptr() and t.shape == s.shape for s in inputs + [radius]), t.shape


def test_function_asks_only_for_the_gradients_autograd_needs(plain_launches, monkeypatch):
    """With only `invd_offset` requiring a gradient (LightGaussian's
    importance render), the backward is asked for that one alone."""
    x, params = scene_params("sh3_alive_offsets", requires_grad=False)
    offset = torch.zeros((params.capacity,), requires_grad=True)
    calls = []
    backward = preprocess.preprocess_backward_reference
    monkeypatch.setattr(preprocess, "preprocess_backward",
                        lambda *a: calls.append(tuple(a[3])) or backward(*a))
    ent, _ = preprocess.preprocess(params, x.camera, alive=x.alive, invd_offset=offset)
    (g,) = torch.autograd.grad(ent[:, 9].sum(), offset)
    assert calls == [tuple(k == "invd_offset" for k in preprocess.GRAD_NAMES)]
    assert torch.equal(g, torch.ones_like(g))


def test_function_takes_cuda_tensors_only():
    """No third route to the plain chain: on CPU tensors the Function
    raises (`render_tiled` calls it only on the card)."""
    _, params = scene_params("sh3_alive_offsets")
    cam = look_at_camera(**synthetic.RANDOM_SCENE_VIEW, device="cpu")
    with pytest.raises(ValueError, match="must share one CUDA device"):
        preprocess.preprocess(params, cam, active_sh_degree=3)


def test_intrinsics_with_a_gradient_raise():
    _, params = scene_params("sh0_of_3")
    cam = look_at_camera(**synthetic.RANDOM_SCENE_VIEW, device="cpu")
    cam = dataclasses.replace(cam, fx=cam.fx.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="intrinsics"):
        preprocess.preprocess(params, cam)


def test_inputs_the_kernels_do_not_take_raise():
    x = case_inputs("sh2_scale_modifier", "cpu", n=50)
    with pytest.raises(ValueError, match="SH degree 3 needs 15"):
        preprocess.check_inputs(dataclasses.replace(x, degree=3))
    with pytest.raises(ValueError, match="float32"):
        preprocess.check_inputs(x.with_tensors({"xyz": x.xyz.double()}))
    with pytest.raises(ValueError, match="must share one CUDA device"):
        preprocess.preprocess_forward(x)


def test_kernels_build_the_preprocess_without_fast_math():
    """`kernels.KERNELS` lists the preprocess; nothing builds it with fast
    math or calls an approximate intrinsic, and no multiply-add is fused."""
    assert "preprocess" in kernels.KERNELS
    flags = kernels.NVCC_FLAGS + kernels.EXTRA_FLAGS["preprocess"]
    assert "-fmad=false" in flags and not any("fast" in f for f in flags)
    for name in ("preprocess.cu", "preprocess.cuh"):
        text = (kernels.CSRC / name).read_text()
        for intrinsic in ("__expf", "__fdividef", "__frcp", "rsqrtf", "__fsqrt", "__fmaf", "fmaf("):
            assert intrinsic not in text, (name, intrinsic)


# ---- render_tiled's plain path ----------------------------------------------


@pytest.mark.parametrize("use_kernel", [True, False])
def test_plain_render_path_is_project_gaussians_and_entry_matrix(use_kernel):
    """On CPU tensors (either `use_kernel`) `render_tiled` is
    `project_gaussians`, binning, `entry_matrix` and the blend, as before
    the kernels: the image, alpha, inverse depth, radii and every gradient
    equal that chain's, bit for bit."""
    arrays = synthetic.random_scene_arrays(seed=0)
    cam = look_at_camera(**synthetic.RANDOM_SCENE_VIEW, device="cpu")
    cfg = RasterConfig(max_tiles_per_gaussian=36, use_kernel=use_kernel)
    h, w = cam.height, cam.width
    outs = {}
    for path in ("render_tiled", "chain"):
        params = params_from_numpy(arrays, "cpu")
        offset = torch.zeros((params.capacity, 2), requires_grad=True)
        invd = torch.zeros((params.capacity,), requires_grad=True)
        bg = torch.tensor([0.1, 0.2, 0.3], requires_grad=True)
        if path == "render_tiled":
            out = render_tiled(params, cam, cfg, background=bg, active_sh_degree=2, means2d_offset=offset,
                               invd_offset=invd)
            img, alpha, invdepth, radii = out.image, out.alpha, out.invdepth, out.radii
        else:
            proj = project_gaussians(params, cam, active_sh_degree=2, means2d_offset=offset)
            bins = build_tile_bins(tiled._detached(proj), h, w, max_tiles_per_gaussian=36)
            ent = entry_matrix(proj, invd)
            nty, ntx = -(-h // 16), -(-w // 16)
            im, aa, dd = tiled._TileBlend.apply(ent, bg, bins.sorted_idx, bins.tile_starts, bins.order,
                                                (nty, ntx, w, h), cfg, False)

            def untile(v):
                v = v[..., None] if v.dim() == 2 else v
                v = v.reshape(nty, ntx, 16, 16, v.shape[-1]).permute(0, 2, 1, 3, 4)
                return v.reshape(nty * 16, ntx * 16, -1)[:h, :w]

            img, alpha, invdepth, radii = untile(im), untile(aa)[..., 0], untile(dd)[..., 0], proj.radius
        loss = (img**2).sum() + 0.3 * (alpha**2).sum() + 0.1 * (invdepth**2).sum()
        leaves = [getattr(params, k) for k in PARAM_NAMES] + [offset, invd, bg]
        outs[path] = [img.detach(), alpha.detach(), invdepth.detach(), radii] + list(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(a, b) for a, b in zip(outs["render_tiled"], outs["chain"]))
