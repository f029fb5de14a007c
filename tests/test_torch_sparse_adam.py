"""The sparse Adam kernel's walk and arithmetic on the host, and the code
around it.

csrc/sparse_adam.cuh holds what one thread of the kernel does with its
CTA's tile of rows; compiled here with g++ (-DDOGS_SPARSE_ADAM_HOST: the
kernel's grid as plain loops, CTA by CTA and thread by thread) it is held bit
for bit against the same chain in numpy float32, whose every operation is
rounded on its own as IEEE says, over the six leaves' widths, row counts
around the tile's, mixed, full and empty visibility, zero gradients and a
zero learning rate. This CPU's PyTorch square root is not always correctly
rounded, so here the plain loop `sparse_adam_step_reference` is held only
within rounding; on the card, where both round as IEEE says, the kernel
equals it bit for bit (tests/test_torch_cuda.py, which imports CASES and
case_inputs from here: no JAX in this file).
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from dogs_tpu_torch import kernels
from dogs_tpu_torch.core import params_from_numpy
from dogs_tpu_torch.core.gaussians import PARAM_NAMES
from dogs_tpu_torch.train import optim

TILE = 128  # rows a CTA (csrc/sparse_adam.cuh kRows)
LRS = dict(xyz=8e-4, feat_dc=2.5e-3, feat_rest=1.25e-4, log_scale=5e-3, quat=1e-3, logit_opacity=0.05)
# case -> rows, SH rest rows (15: SH 3, the six widths 3, 3, 45, 3, 4, 1) and
# visibility; zero gradients or learning rates where named.
CASES = {
    **{f"n{n}_{vis}": dict(n=n, rest=15, vis=vis)
       for n in (1, TILE, TILE + 3, 1000) for vis in ("mixed", "all", "none") if (n, vis) != (1, "mixed")},
    "sh0_mixed": dict(n=TILE + 3, rest=0, vis="mixed"),
    "sh1_mixed": dict(n=TILE + 3, rest=3, vis="mixed"),
    "sh2_all": dict(n=1000, rest=8, vis="all"),
    "zero_grads": dict(n=1000, rest=15, vis="mixed", zero_grads=True),
    "lr_zero": dict(n=1000, rest=15, vis="all", lr=0.0),
}


def case_arrays(case: str) -> dict:
    """One case's numpy inputs: p, g, m, v (leaf -> array), visible, lrs.
    "mixed" visibility has a run of 4 invisible rows and, past two tiles, a
    whole invisible tile."""
    c = CASES[case]
    n, rng = c["n"], np.random.RandomState(list(CASES).index(case))
    shapes = dict(xyz=(n, 3), feat_dc=(n, 1, 3), feat_rest=(n, c["rest"], 3), log_scale=(n, 3), quat=(n, 4),
                  logit_opacity=(n, 1))
    p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.randn(*s) * (0.0 if c.get("zero_grads") else 1e-2)).astype(np.float32) for k, s in shapes.items()}
    m = {k: (rng.randn(*s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
    v = {k: (rng.rand(*s) * 1e-4).astype(np.float32) for k, s in shapes.items()}
    if c["vis"] == "mixed":
        visible = rng.rand(n) > 0.4
        visible[4:8] = False
        visible[2 * TILE:3 * TILE] = False
    else:
        visible = np.full(n, c["vis"] == "all")
    lrs = {k: c.get("lr", lr) for k, lr in LRS.items()}
    return dict(p=p, g=g, m=m, v=v, visible=visible, lrs=lrs)


def case_inputs(case: str, dev) -> tuple:
    """(params, grads, state, visible, lrs) of a case on `dev`, fresh copies."""
    a = case_arrays(case)

    def t(x):
        return torch.as_tensor(x.copy(), device=dev)

    state = optim.SparseAdamState(mu={k: t(a["m"][k]) for k in PARAM_NAMES}, nu={k: t(a["v"][k]) for k in PARAM_NAMES})
    return (params_from_numpy({k: x.copy() for k, x in a["p"].items()}, dev), {k: t(a["g"][k]) for k in PARAM_NAMES},
            state, t(a["visible"]), a["lrs"])


def ieee_chain(a: dict) -> dict:
    """leaf -> (p, m, v) after the step: the plain loop's operations in
    numpy float32, each rounded on its own."""
    f = np.float32
    out = {}
    for k in PARAM_NAMES:
        p, g, m, v = a["p"][k], a["g"][k], a["m"][k], a["v"][k]
        mask = a["visible"].reshape((-1,) + (1,) * (p.ndim - 1))
        m2 = f(0.9) * m + f(1.0 - 0.9) * g
        v2 = f(0.999) * v + f(1.0 - 0.999) * g * g
        p2 = p + f(-a["lrs"][k]) * m2 / (np.sqrt(v2) + f(1e-15))
        out[k] = tuple(np.where(mask, new, old) for new, old in ((p2, p), (m2, m), (v2, v)))
    return out


def after(params, state) -> dict:
    return {k: tuple(x.detach().cpu().numpy() for x in (getattr(params, k), state.mu[k], state.nu[k]))
            for k in PARAM_NAMES}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/sparse_adam.cuh's host grid, compiled with g++ without FMA
    contraction, as the kernel's -fmad=false."""
    d = tmp_path_factory.mktemp("sparse_adam_host")
    src = d / "sparse_adam_host.cpp"
    src.write_text(f'#include "{kernels.CSRC / "sparse_adam.cuh"}"\n')
    lib_path = d / "sparse_adam_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    "-DDOGS_SPARSE_ADAM_HOST", "-o", str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.dogs_sparse_adam_host.argtypes = [ctypes.POINTER(optim.KernelArgs)]
    return lib


def host_step(lib, params, grads, state, visible, lrs) -> None:
    """The wrapper's argument struct, run by the host grid."""
    leaves = optim.kernel_inputs(params, grads, state, visible)
    args = optim.kernel_args(leaves, visible, lrs, 0.9, 0.999, 1e-15)
    with torch.no_grad():
        assert lib.dogs_sparse_adam_host(ctypes.byref(args)) == 0


@pytest.mark.parametrize("case", list(CASES))
def test_host_grid_equals_the_ieee_chain_bit_for_bit(case, host):
    params, grads, state, visible, lrs = case_inputs(case, "cpu")
    host_step(host, params, grads, state, visible, lrs)
    want = ieee_chain(case_arrays(case))
    for k, got in after(params, state).items():
        for what, a, b in zip(("p", "m", "v"), got, want[k]):
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), (k, what)


@pytest.mark.parametrize("case", ["n1000_mixed", "sh0_mixed", "zero_grads"])
def test_host_grid_matches_the_plain_loop(case, host):
    """Against `sparse_adam_step_reference` on CPU tensors: the moments bit
    for bit, the parameters within the rounding of this CPU's square root;
    rows that are not visible untouched."""
    a = case_arrays(case)
    got, want = case_inputs(case, "cpu"), case_inputs(case, "cpu")
    host_step(host, *got)
    optim.sparse_adam_step_reference(*want)
    got, want = after(got[0], got[2]), after(want[0], want[2])
    for k in PARAM_NAMES:
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-6, atol=1e-7)
        for x, y in zip(got[k][1:], want[k][1:]):
            np.testing.assert_array_equal(x, y)
        for x, before in zip(got[k], (a["p"][k], a["m"][k], a["v"][k])):
            np.testing.assert_array_equal(x[~a["visible"]], before[~a["visible"]])


def test_kernel_inputs_raise_on_what_the_kernel_does_not_take():
    params, grads, state, visible, _ = case_inputs("n131_mixed", "cpu")
    n = visible.shape[0]
    with pytest.raises(ValueError, match="visible"):
        optim.kernel_inputs(params, grads, state, visible.to(torch.uint8))
    with pytest.raises(ValueError, match="visible"):
        optim.kernel_inputs(params, grads, state, visible[:-1])
    with pytest.raises(ValueError, match="gradient of quat"):
        optim.kernel_inputs(params, dict(grads, quat=grads["quat"].double()), state, visible)
    with pytest.raises(ValueError, match="first moment of xyz"):
        optim.kernel_inputs(params, grads, optim.SparseAdamState(dict(state.mu, xyz=state.mu["xyz"][:, :2]),
                                                                 state.nu), visible)
    strided = torch.empty((3, n)).t()
    with pytest.raises(ValueError, match="second moment of log_scale must be contiguous"):
        optim.kernel_inputs(params, grads, optim.SparseAdamState(state.mu, dict(state.nu, log_scale=strided)),
                            visible)
    shifted = torch.empty(n * 3 + 1)[1:].view(n, 3)  # contiguous, 4 bytes past an aligned start
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="first moment of xyz must be contiguous and 16-byte aligned"):
        optim.kernel_inputs(params, grads, optim.SparseAdamState(dict(state.mu, xyz=shifted), state.nu), visible)
    params.xyz = torch.nn.Parameter(torch.empty(n * 3 + 1)[1:].view(n, 3))
    assert params.xyz.data_ptr() % 16
    with pytest.raises(ValueError, match="parameter of xyz must be contiguous and 16-byte aligned"):
        optim.kernel_inputs(params, grads, state, visible)


def test_kernel_inputs_copy_a_strided_or_shifted_gradient():
    params, grads, state, visible, _ = case_inputs("n131_mixed", "cpu")
    n = visible.shape[0]
    strided = torch.empty((3, n)).t()
    strided.copy_(grads["xyz"])
    shifted = torch.empty(n * 4 + 1)[1:].view(n, 4)
    shifted.copy_(grads["quat"])
    leaves = optim.kernel_inputs(params, dict(grads, xyz=strided, quat=shifted), state, visible)
    for k, g in (("xyz", leaves["xyz"][1]), ("quat", leaves["quat"][1])):
        assert g.is_contiguous() and g.data_ptr() % 16 == 0 and torch.equal(g, grads[k]), k
    assert leaves["feat_rest"][1] is grads["feat_rest"]  # taken as it is


def test_kernel_structs_match_the_header():
    """Field offsets of csrc/sparse_adam.cuh's Leaf and Args (x86-64 and
    the card: 8-byte pointers and long long, 4-byte float)."""
    assert [getattr(optim.KernelLeaf, f).offset for f in ("p", "g", "m", "v", "width", "neg_lr")] == [
        0, 8, 16, 24, 32, 40]
    assert ctypes.sizeof(optim.KernelLeaf) == 48
    assert [getattr(optim.KernelArgs, f).offset for f in ("leaf", "visible", "n", "b1", "eps")] == [
        0, 288, 296, 304, 320]


def test_kernels_build_the_sparse_adam_without_fast_math():
    """`kernels.KERNELS` lists the sparse Adam; nothing builds it with fast
    math or calls an approximate intrinsic, and no multiply-add is fused."""
    assert "sparse_adam" in kernels.KERNELS
    flags = kernels.NVCC_FLAGS + kernels.EXTRA_FLAGS["sparse_adam"]
    assert "-fmad=false" in flags and not any("fast" in f for f in flags)
    for name in ("sparse_adam.cu", "sparse_adam.cuh"):
        text = (kernels.CSRC / name).read_text()
        for intrinsic in ("__fdividef", "__frcp", "rsqrtf", "__fsqrt", "__fmaf", "fmaf(", "__fmul", "__fadd"):
            assert intrinsic not in text, (name, intrinsic)
