"""The SSIM kernels' walk and arithmetic on the host, and the code around
them.

csrc/ssim.cuh holds what one thread of the forward and backward kernels
does with its CTA's tile; compiled here with g++ (-DDOGS_SSIM_HOST: the
kernels' grids as plain loops, CTA by CTA and each phase thread by thread)
its map is held bit for bit against `ssim_map`, its loss against the map's
mean, and its gradient against float64 autograd through `ssim_map`: no
further from it than twice the plain float32 autograd's distance. The cases
cover sizes that are not multiples of the 16x32 tile, images smaller than the
window's halo, one and three channels, a batch, and uncorrelated, identical,
dark and saturated pairs. Then `ssim` on CPU tensors (the plain path) and
`_SSIM`'s wiring on CPU tensors with its two launches run by the host build.
The kernels themselves run in tests/test_torch_cuda.py, which imports CASES
and case_tensors from here (no JAX in this file).
"""

import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch

from dogs_tpu_torch import kernels
from dogs_tpu_torch.raster.ssim import (TILE, WINDOW, KernelArgs, _SSIM, check_kernel_inputs, kernel_args, num_tiles,
                                        ssim, ssim_map)

G = -0.2  # the cotangent of the mean SSIM in the trainers' loss (lambda_dssim 0.2, 1 - ssim)
# case -> shape and how img2 is drawn from img1 (see case_tensors)
CASES = {
    "noisy_37x45x3": ((37, 45, 3), "noisy"),
    "tiles_32x64x3": ((32, 64, 3), "noisy"),
    "below_halo_3x4x3": ((3, 4, 3), "noisy"),
    "pixel_1x1x1": ((1, 1, 1), "noisy"),
    "gray_20x70x1": ((20, 70, 1), "noisy"),
    "batch_2x19x33x3": ((2, 19, 33, 3), "noisy"),
    "uncorrelated_64x96x3": ((64, 96, 3), "uncorrelated"),
    "identical_37x45x3": ((37, 45, 3), "identical"),
    "dark_37x45x3": ((37, 45, 3), "dark"),
    "saturated_50x40x3": ((50, 40, 3), "saturated"),
}


def case_tensors(case: str, dev="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(img1, img2) of a case in f32 on `dev`, drawn with numpy."""
    shape, kind = CASES[case]
    rng = np.random.RandomState(list(CASES).index(case))
    a = rng.rand(*shape)
    b = {
        "noisy": lambda: np.clip(a + rng.randn(*shape) * 0.05, 0.0, 1.0),
        "uncorrelated": lambda: rng.rand(*shape),
        "identical": lambda: a,
        "dark": lambda: rng.rand(*shape) * 0.02,
        "saturated": lambda: np.clip(rng.randn(*shape) * 2.0, 0.0, 1.0),
    }[kind]()
    if kind == "dark":
        a = a * 0.02
    elif kind == "saturated":
        a = np.clip(rng.randn(*shape) * 2.0, 0.0, 1.0)
    return (torch.as_tensor(a.astype(np.float32), device=dev), torch.as_tensor(b.astype(np.float32), device=dev))


def plain_gradients(img1: torch.Tensor, img2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """G times the mean of `ssim_map`'s gradient in img1: by autograd in f32,
    and in float64 (the yardstick)."""
    out = []
    for dtype in (torch.float32, torch.float64):
        x = img1.to(dtype).requires_grad_(True)
        (g,) = torch.autograd.grad(G * ssim_map(x, img2.to(dtype)).mean(), [x])
        out.append(g)
    return out[0], out[1]


def assert_gradient_within_the_bar(got: torch.Tensor, img1: torch.Tensor, img2: torch.Tensor) -> None:
    """No further from float64 autograd than twice the plain f32 autograd."""
    g32, g64 = plain_gradients(img1, img2)
    err = float((got.double() - g64).abs().max())
    plain = float((g32.double() - g64).abs().max())
    assert err <= 2.0 * plain, (err, plain)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/ssim.cuh's host grids, compiled with g++ without FMA
    contraction, as the kernels' -fmad=false."""
    d = tmp_path_factory.mktemp("ssim_host")
    src = d / "ssim_host.cpp"
    src.write_text(f'#include "{kernels.CSRC / "ssim.cuh"}"\n')
    lib_path = d / "ssim_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    "-DDOGS_SSIM_HOST", "-o", str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("dogs_ssim_forward_host", "dogs_ssim_backward_host"):
        getattr(lib, name).argtypes = [ctypes.POINTER(KernelArgs)]
    return lib


def host_run(lib, img1, img2) -> dict:
    """The forward (map, partials, loss and derivative maps) and the
    backward at cotangent G, by the host grids."""
    out = dict(loss=torch.empty(()), partial=torch.empty(num_tiles(img1)), dmap=torch.empty((3,) + img1.shape),
               map=torch.empty_like(img1))
    assert lib.dogs_ssim_forward_host(ctypes.byref(kernel_args(img1, img2, **out))) == 0
    out["dx"], grad = torch.empty_like(img1), torch.tensor(G)
    args = kernel_args(img1, img2, dmap=out["dmap"], grad=grad, dx=out["dx"])
    assert lib.dogs_ssim_backward_host(ctypes.byref(args)) == 0
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_host_map_equals_ssim_map_bit_for_bit(case, host):
    img1, img2 = case_tensors(case)
    got = host_run(host, img1, img2)["map"]
    want = ssim_map(img1, img2)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_host_loss_is_the_maps_mean(case, host):
    """The partials sum each tile's map; the loss is their mean, no
    further from the float64 mean than the plain f32 mean (or 1e-7)."""
    img1, img2 = case_tensors(case)
    out = host_run(host, img1, img2)
    want = ssim_map(img1, img2)
    b = 1 if want.dim() == 3 else want.shape[0]
    tiles = want.reshape(b, *want.shape[-3:])
    h, w = tiles.shape[1:3]
    sums = [float(tiles[i, y:y + TILE[0], x:x + TILE[1]].double().sum())
            for i in range(b) for y in range(0, h, TILE[0]) for x in range(0, w, TILE[1])]
    np.testing.assert_allclose(out["partial"].numpy(), sums, rtol=1e-5, atol=1e-5)
    mean64 = float(ssim_map(img1.double(), img2.double()).mean())
    assert abs(float(out["loss"]) - mean64) <= max(abs(float(want.mean()) - mean64), 1e-7)


@pytest.mark.parametrize("case", list(CASES))
def test_host_gradient_within_twice_the_plain_f32_error(case, host):
    img1, img2 = case_tensors(case)
    assert_gradient_within_the_bar(host_run(host, img1, img2)["dx"], img1, img2)


def test_ssim_on_cpu_tensors_is_the_plain_path():
    """On the CPU `ssim` is `ssim_map`'s mean bit for bit, its gradient
    autograd's through it, and nothing is launched."""
    img1, img2 = case_tensors("batch_2x19x33x3")
    before = kernels.launches.copy()
    x = img1.clone().requires_grad_(True)
    got = ssim(x, img2)
    (g,) = torch.autograd.grad(got, [x])
    y = img1.clone().requires_grad_(True)
    want = ssim_map(y, img2).mean()
    (h,) = torch.autograd.grad(want, [y])
    assert torch.equal(got, want) and torch.equal(g, h)
    assert kernels.launches == before


@pytest.mark.parametrize("case", ["noisy_37x45x3", "batch_2x19x33x3"])
def test_autograd_node_with_host_launches(case, host, monkeypatch):
    """`_SSIM` on CPU tensors with the two launches run by the host build:
    one forward and one backward launch, the host's loss, and the gradient
    of 1 - 0.2 ssim within the bar; (B, H, W, C) input included."""
    img1, img2 = case_tensors(case)

    def launch(name, symbol, argtypes, args, device=None):
        assert name == "ssim" and getattr(host, f"{symbol}_host")(args) == 0
        kernels.launches[symbol] += 1

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)
    before = kernels.launches.copy()
    x = img1.clone().requires_grad_(True)
    loss = 1.0 + G * _SSIM.apply(x, img2)
    (g,) = torch.autograd.grad(loss, [x])
    assert kernels.launches - before == {"dogs_ssim_forward": 1, "dogs_ssim_backward": 1}
    want = host_run(host, img1, img2)
    assert torch.equal(loss, 1.0 + G * want["loss"])
    assert torch.equal(g, want["dx"])
    assert_gradient_within_the_bar(g, img1, img2)


def test_kernel_inputs_raise_on_what_the_kernels_do_not_take():
    img1, img2 = case_tensors("noisy_37x45x3")
    with pytest.raises(ValueError, match="float32"):
        check_kernel_inputs(img1.double(), img2.double())
    with pytest.raises(ValueError, match="contiguous"):
        check_kernel_inputs(img1.transpose(0, 1), img2.transpose(0, 1))
    with pytest.raises(ValueError, match="img2 is the target"):
        check_kernel_inputs(img1, img2.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="shape"):
        check_kernel_inputs(img1, img2[:-1])
    with pytest.raises(ValueError, match="CUDA device"):
        check_kernel_inputs(img1, img2)


def test_kernel_struct_and_tile_match_the_header():
    """Field offsets of csrc/ssim.cuh's Args (x86-64 and the card: 8-byte
    pointers and long long, 4-byte int and float), and its tile."""
    assert [getattr(KernelArgs, f).offset for f in ("x", "dx", "batch", "height", "channels", "window", "c1", "c2")] \
        == [0, 56, 64, 72, 80, 84, 128, 132]
    assert ctypes.sizeof(KernelArgs) == 136
    text = (kernels.CSRC / "ssim.cuh").read_text()
    assert TILE == tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1)) for k in ("kTileH", "kTileW"))
    assert int(re.search(r"constexpr int kTaps = (\d+);", text).group(1)) == WINDOW


def test_kernels_build_the_ssim_without_fast_math():
    """`kernels.KERNELS` lists the SSIM; nothing builds it with fast math or
    calls an approximate intrinsic, and no multiply-add is fused."""
    assert "ssim" in kernels.KERNELS
    flags = kernels.NVCC_FLAGS + kernels.EXTRA_FLAGS["ssim"]
    assert "-fmad=false" in flags and not any("fast" in f for f in flags)
    for name in ("ssim.cu", "ssim.cuh"):
        text = (kernels.CSRC / name).read_text()
        for intrinsic in ("__fdividef", "__frcp", "rsqrtf", "__fsqrt", "__fmaf", "fmaf(", "__fmul", "__fadd",
                          "atomicAdd"):
            assert intrinsic not in text, (name, intrinsic)

