"""CUDA lane: the hand-written kernels (blend forward, blend backward,
segment sum) against their plain PyTorch versions on the card, the
LightGaussian importance render and the Scaffold-GS render and step through
them, and the densify surgery, LPIPS, the windowed KNN, the appearance mask
CNN and the Scaffold-GS decode on the card against the CPU. The kernel
scenes include a coarse-to-fine frame with a partial tile row. Every test here needs a CUDA
device and skips without one. The file imports no JAX, so it runs on a machine with the card alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest` skips tests/conftest.py, which sets up JAX for the CPU suite.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from dogs_tpu_torch.core import look_at_camera, params_from_numpy
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.core.gaussians import PARAM_NAMES
from dogs_tpu_torch.core.knn import mean_knn_dist_sq, morton_codes
from dogs_tpu_torch.eval.metrics import lpips
from dogs_tpu_torch.fields import appearance
from dogs_tpu_torch.fields import lightgaussian
from dogs_tpu_torch.fields import model as tmodel
from dogs_tpu_torch.raster import blend, reduce
from dogs_tpu_torch.raster.binning import build_tile_bins
from dogs_tpu_torch.raster.projection import project_gaussians
from dogs_tpu_torch.raster.tiled import RasterConfig, entry_matrix, render_tiled
from dogs_tpu_torch.train import trainer as ttrainer
from dogs_tpu_torch.train.optim import SparseAdamState

pytestmark = pytest.mark.cuda
ATOL = 3e-4  # forward parity bar of tests/test_pallas_blend.py
GRAD_ATOL = 2e-3  # max-normalized gradient bar of tests/test_pallas_blend.py:58-61
MT = 36

SCENES = {
    "random_seed0": (lambda: synthetic.random_scene_arrays(seed=0), synthetic.RANDOM_SCENE_VIEW, 2),
    "saturation": (synthetic.saturation_scene_arrays, synthetic.SATURATION_SCENE_VIEW, 1),
    # Dense enough that whole tiles stop before their last entry.
    "saturation_dense": (lambda: synthetic.saturation_scene_arrays(n=256), synthetic.SATURATION_SCENE_VIEW, 1),
    "empty_tiles": (
        lambda: synthetic.random_scene_arrays(n=16, seed=2, spread=0.3),
        synthetic.RANDOM_SCENE_VIEW, 2,
    ),
    "non_aligned_200x130": (
        lambda: synthetic.random_scene_arrays(n=400, seed=5),
        dict(synthetic.RANDOM_SCENE_VIEW, width=200, height=130, fx=120.0, fy=120.0), 2,
    ),
    # A coarse-to-fine frame at factor 4 of 1152x864: 13.5 tile rows.
    "partial_row_288x216": (
        lambda: synthetic.random_scene_arrays(n=600, seed=6),
        dict(synthetic.RANDOM_SCENE_VIEW, width=288, height=216, fx=170.0, fy=170.0), 2,
    ),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda", 0)


@torch.no_grad()
def blend_args(scene, dev):
    """(ent_n, sorted_idx, starts, n_tiles_y, n_tiles_x, width, height) of a scene."""
    make, view, deg = SCENES[scene]
    h, w = view["height"], view["width"]
    params = params_from_numpy(make(), dev)
    proj = project_gaussians(params, look_at_camera(**view, device=dev), active_sh_degree=deg)
    bins = build_tile_bins(proj, h, w, max_tiles_per_gaussian=MT)
    grid = (-(-h // 16), -(-w // 16), w, h)
    return (entry_matrix(proj), bins.sorted_idx, bins.tile_starts, *grid), bins


def in_image(args):
    """(T, 256) mask of the tile pixels inside the image."""
    *_, nty, ntx, w, h = args
    dev = args[0].device
    p = torch.arange(256, device=dev)
    tiles = torch.arange(nty * ntx, device=dev)[:, None]
    return (((tiles % ntx) * 16 + p % 16) < w) & (((tiles // ntx) * 16 + p // 16) < h)


def random_cot(args, seed):
    """A cotangent drawn from a seeded generator, with Gtot from the plain
    forward totals, zero past the image edge."""
    dev = args[0].device
    out = blend.blend_forward_reference(*args)
    g = torch.Generator(device=dev).manual_seed(seed)
    inside = in_image(args)
    t = inside.shape[0]
    cot_img = torch.randn((t, 256, 3), generator=g, device=dev) * inside[..., None]
    cot_a = torch.randn((t, 256), generator=g, device=dev) * inside
    cot_d = torch.randn((t, 256), generator=g, device=dev) * inside
    return blend.backward_cotangent(out, cot_img, cot_a, cot_d, torch.zeros(3, device=dev))


def assert_columns_close(got, want, ncols, atol):
    for c in range(ncols):
        scale = float(want[:, c].abs().max()) + 1e-6
        torch.testing.assert_close(got[:, c] / scale, want[:, c] / scale, atol=atol, rtol=0,
                                   msg=lambda m: f"column {c}: {m}")


@pytest.mark.parametrize("scene", list(SCENES))
def test_blend_kernel_matches_reference_on_card(scene, cuda):
    with torch.no_grad():
        args, _ = blend_args(scene, cuda)
        before = blend.blend_forward.launches
        got = blend.blend_forward(*args)
        want = blend.blend_forward_reference(*args)
    torch.cuda.synchronize()
    assert blend.blend_forward.launches == before + 1
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_render_uses_kernel_on_card(cuda):
    make, view, deg = SCENES["random_seed0"]
    params = params_from_numpy(make(), cuda)
    cam = look_at_camera(**view, device=cuda)
    bg = torch.tensor([0.15, 0.25, 0.35], device=cuda)
    before = blend.blend_forward.launches
    got = render_tiled(params, cam, RasterConfig(max_tiles_per_gaussian=MT), background=bg,
                       active_sh_degree=deg)
    assert blend.blend_forward.launches == before + 1
    want = render_tiled(params, cam, RasterConfig(max_tiles_per_gaussian=MT, use_kernel=False),
                        background=bg, active_sh_degree=deg)
    assert blend.blend_forward.launches == before + 1
    for f in ("image", "alpha", "invdepth"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), atol=ATOL, rtol=0)


@pytest.mark.parametrize("depth_threshold", [0.0, 4.5])
@pytest.mark.parametrize("scene", list(SCENES))
def test_blend_backward_kernel_matches_reference_and_is_deterministic(scene, depth_threshold, cuda):
    args, _ = blend_args(scene, cuda)
    cot = random_cot(args, seed=7)
    ent_n, idx, starts, *grid = args
    kw = dict(depth_threshold=depth_threshold)
    before = blend.blend_backward.launches
    got = blend.blend_backward(ent_n, idx, starts, cot, *grid, **kw)
    again = blend.blend_backward(ent_n, idx, starts, cot, *grid, **kw)
    want = blend.blend_backward_reference(ent_n, idx, starts, cot, *grid, **kw)
    torch.cuda.synchronize()
    assert blend.blend_backward.launches == before + 2
    assert torch.equal(got, again)  # no atomics: bit-identical
    assert torch.isfinite(got).all() and not got[:, 10:].any()
    assert_columns_close(got, want, 10, GRAD_ATOL)


@pytest.mark.parametrize("scene", ["saturation_dense", "random_seed0"])
def test_forward_and_backward_kernels_take_the_same_stop_decision(scene, cuda):
    """Rows past the entry where the plain forward has stopped every pixel
    of the tile are exactly zero in the backward kernel's output, and the
    forward totals the backward replays (d_rgb = sum over pixels of w gC,
    with gC a per-pixel draw) equal the forward kernel's, tile by tile."""
    with torch.no_grad():
        args, _ = blend_args(scene, cuda)
        ent_n, idx, starts, *grid = args
        work = blend.blend_work(*args)
        fwd = blend.blend_forward(*args)
        inside = in_image(args)
        g = torch.Generator(device=cuda).manual_seed(9)
        t = inside.shape[0]
        gc = torch.rand((t, 3, 256), generator=g, device=cuda) * inside[:, None]
        cot = torch.zeros((t, blend.COT_ROWS, 256), device=cuda)
        cot[:, 0:3] = gc
        d_ent = blend.blend_backward(ent_n, idx, starts, cot, *grid)
        torch.cuda.synchronize()
    tile_of = torch.repeat_interleave(torch.arange(t, device=cuda), (starts[1:] - starts[:-1]).long())
    pos = torch.arange(idx.shape[0], device=cuda)
    past = pos >= work.tile_end[tile_of]
    if scene == "saturation_dense":
        assert past.any()  # some tile stops before its last entry
    assert not d_ent[past].any()
    replayed = torch.zeros((t, 3), device=cuda).index_add_(0, tile_of, d_ent[:, 5:8])
    totals = (gc * fwd[:, 3:4]).sum(dim=2)  # sum over pixels of gC A
    torch.testing.assert_close(replayed, totals, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("reduce_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_segment_sum_kernel_matches_reference_and_is_deterministic(scene, reduce_dtype, cuda):
    args, bins = blend_args(scene, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    d_ent = torch.randn((args[1].shape[0], blend.ENT_WIDTH), generator=g, device=cuda)
    n = int(bins.sorted_idx.max()) + 5 if bins.sorted_idx.numel() else 5
    src, starts = reduce.gaussian_runs(bins.order, bins.sorted_idx, n)
    before = reduce.sorted_segment_sum.launches
    got = reduce.sorted_segment_sum(d_ent, src, starts, n, reduce_dtype)
    again = reduce.sorted_segment_sum(d_ent, src, starts, n, reduce_dtype)
    want = reduce.sorted_segment_sum_reference(d_ent, src, starts, n, reduce_dtype)
    torch.cuda.synchronize()
    assert reduce.sorted_segment_sum.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, want)  # the same f32 adds in the same order


def test_segment_sum_kernel_long_run_and_dropped_ids(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    ids = torch.cat([torch.zeros(5000, dtype=torch.int32, device=cuda),
                     torch.full((300,), 7, dtype=torch.int32, device=cuda),
                     torch.full((50,), 2**31 - 1, dtype=torch.int32, device=cuda)])
    rows = torch.randn((ids.shape[0], blend.ENT_WIDTH), generator=g, device=cuda)
    # The runs gather their rows through a random permutation.
    src = torch.randperm(ids.shape[0], generator=g, device=cuda).to(torch.int32)
    _, starts = reduce.runs_from_sorted_ids(ids, 8)
    got = reduce.sorted_segment_sum(rows, src, starts, 8)
    want = reduce.sorted_segment_sum_reference(rows, src, starts, 8)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # the 5000-row run in order on both sides
    assert not got[1:7].any() and not got[:, 10:].any()


@pytest.mark.parametrize("reduce_dtype", ["f32", "bf16"])
def test_render_backward_goes_through_all_three_kernels(reduce_dtype, cuda):
    make, view, deg = SCENES["random_seed0"]
    cam = look_at_camera(**view, device=cuda)
    target = torch.rand((view["height"], view["width"], 3), generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
    grads = {}
    for use_kernel in (True, False):
        params = params_from_numpy(make(), cuda)
        bg = torch.tensor([0.1, 0.2, 0.3], device=cuda, requires_grad=True)
        cfg = RasterConfig(max_tiles_per_gaussian=MT, use_kernel=use_kernel, reduce_dtype=reduce_dtype)
        counts = [blend.blend_forward.launches, blend.blend_backward.launches,
                  reduce.sorted_segment_sum.launches]
        out = render_tiled(params, cam, cfg, background=bg, active_sh_degree=deg)
        loss = ((out.image - target) ** 2).sum() + 0.3 * (out.alpha**2).sum() + 0.1 * (out.invdepth**2).sum()
        leaves = [getattr(params, k) for k in PARAM_NAMES] + [bg]
        grads[use_kernel] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        after = [blend.blend_forward.launches, blend.blend_backward.launches,
                 reduce.sorted_segment_sum.launches]
        assert [a - b for a, b in zip(after, counts)] == ([1, 1, 1] if use_kernel else [0, 0, 0])
    for name, a, b in zip(PARAM_NAMES + ("background",), grads[False], grads[True]):
        scale = float(a.abs().max()) + 1e-6
        torch.testing.assert_close(b / scale, a / scale, atol=GRAD_ATOL, rtol=0, msg=lambda m: f"{name}: {m}")


def densify_inputs(device):
    """A model state with clones, splits, every prune rule and an overflow
    (numpy-drawn, 56 of 64 slots alive), split noise and Adam moments."""
    rng = np.random.RandomState(7)
    c, n = 64, 56
    arrays = synthetic.random_scene_arrays(n=c, seed=7, max_sh_degree=1)
    arrays["log_scale"] = np.log(rng.uniform(0.001, 0.015, (c, 3))).astype(np.float32)
    arrays["log_scale"][:2] = np.log(0.5)
    arrays["logit_opacity"][2:4] = -6.5
    alive = np.arange(c) < n
    denom = rng.randint(0, 4, c).astype(np.float32)
    stats = dict(grad_accum=(denom * rng.uniform(0.0, 1.0, c)).astype(np.float32), denom=denom,
                 max_radii2d=rng.uniform(0.0, 105.0, c).astype(np.float32))
    state = tmodel.GaussianModelState(
        params=params_from_numpy(arrays, device), alive=torch.as_tensor(alive, device=device),
        **{k: torch.as_tensor(v, device=device) for k, v in stats.items()},
    )
    moments = {m: {k: torch.as_tensor(rng.randn(*a.shape).astype(np.float32), device=device)
                   for k, a in arrays.items()} for m in ("mu", "nu")}
    noise = torch.as_tensor(rng.randn(2 * c, 3).astype(np.float32), device=device)
    return state, SparseAdamState(**moments), noise


def test_densify_surgery_on_card_matches_cpu_without_host_sync(cuda):
    """densify_and_prune, zero_moments_at and reset_opacity on the card equal
    the same functions on CPU copies, and make no host sync."""
    out = {}
    for dev in (torch.device("cpu"), cuda):
        state, opt, noise = densify_inputs(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            _, allocated, overflow = tmodel.densify_and_prune(state, noise, 0.5, 0.005, 1.0, 100.0)
            ttrainer.zero_moments_at(opt, allocated)
            tmodel.reset_opacity(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[dev.type] = (state, opt, allocated, overflow)
    (s_cpu, o_cpu, a_cpu, v_cpu), (s_gpu, o_gpu, a_gpu, v_gpu) = out["cpu"], out["cuda"]
    assert int(v_gpu) == int(v_cpu) > 0 and int(a_cpu.sum()) > 0
    assert torch.equal(a_gpu.cpu(), a_cpu) and torch.equal(s_gpu.alive.cpu(), s_cpu.alive)
    for k in PARAM_NAMES:
        torch.testing.assert_close(getattr(s_gpu.params, k).detach().cpu(), getattr(s_cpu.params, k).detach(),
                                   atol=1e-6, rtol=0, msg=lambda m: f"{k}: {m}")
        for m in ("mu", "nu"):
            assert torch.equal(getattr(o_gpu, m)[k].cpu(), getattr(o_cpu, m)[k]), (m, k)


def test_importance_render_goes_through_the_kernels_and_matches_plain(cuda):
    """One VJP through the invD column: K1 forward, K2 and K3 backward, once
    each; within the gradient bar of the plain path."""
    make, view, deg = SCENES["random_seed0"]
    arrays = make()
    alive = torch.as_tensor(np.random.RandomState(3).rand(arrays["xyz"].shape[0]) > 0.2, device=cuda)
    model = tmodel.GaussianModelState(params_from_numpy(arrays, cuda), alive,
                                      *tmodel.fresh_stats(arrays["xyz"].shape[0], cuda))
    cam = look_at_camera(**view, device=cuda)
    counts = [blend.blend_forward.launches, blend.blend_backward.launches, reduce.sorted_segment_sum.launches]
    got = lightgaussian.importance_render(model, cam, RasterConfig(max_tiles_per_gaussian=MT), deg)
    after = [blend.blend_forward.launches, blend.blend_backward.launches, reduce.sorted_segment_sum.launches]
    want = lightgaussian.importance_render(model, cam, RasterConfig(max_tiles_per_gaussian=MT, use_kernel=False), deg)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1]
    scale = float(want.abs().max())
    assert scale > 0 and not got[~alive].any()
    torch.testing.assert_close(got / scale, want / scale, atol=GRAD_ATOL, rtol=0)
    assert all(p.grad is None for p in model.params.parameters())


def test_lpips_on_card_matches_cpu_with_tf32_off(cuda):
    """The convolutions run in f32 on the card (cuDNN's TF32 is off inside
    the call only): within 1e-5 relative of the CPU value."""
    g = torch.Generator().manual_seed(0)
    pred, gt = torch.rand((120, 160, 3), generator=g), torch.rand((120, 160, 3), generator=g)
    before = torch.backends.cudnn.allow_tf32
    got, calibrated = lpips(pred.to(cuda), gt.to(cuda))
    want, _ = lpips(pred, gt)
    assert torch.backends.cudnn.allow_tf32 == before
    assert got.device.type == "cuda" and not calibrated
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_windowed_knn_on_card_matches_cpu(cuda):
    """Above 2,048 points: the same Morton codes and stable order on the
    card; the distances within f32 rounding of the CPU's."""
    rng = np.random.RandomState(5000)
    pts = torch.as_tensor((rng.randn(5000, 3) * rng.uniform(0.1, 3.0, 3)).astype(np.float32))
    valid = torch.as_tensor(rng.rand(5000) > 0.2)
    codes = morton_codes(pts, valid)
    assert torch.equal(morton_codes(pts.to(cuda), valid.to(cuda)).cpu(), codes)
    got = mean_knn_dist_sq(pts.to(cuda), valid.to(cuda)).cpu()
    torch.testing.assert_close(got, mean_knn_dist_sq(pts, valid), rtol=1e-6, atol=0)


@pytest.mark.parametrize("hw", [(80, 96), (432, 576)], ids=["96x80", "576x432"])
def test_appearance_mask_on_card_matches_cpu_with_tf32_off(hw, cuda, monkeypatch):
    """The mask CNN's forward (1e-5 of the max) and its parameter and input
    gradients (2e-3 of each leaf's max) on the card against the CPU, the
    convolutions and their backward in exact f32 (`exact_f32`), at 96x80
    and at a coarse-to-fine frame (576x432: an antialiased x32 downsample
    to 18x13 at a ratio of 33.2), and the settings restored after. The CPU
    takes the card's ReLU branch (each ReLU input's sign recorded on the
    card): an input within f32 rounding of 0 may take the other branch on
    either device and move a gradient by ~1e-2 of its leaf's max."""
    arrays = appearance.init_appearance_arrays(4)
    g = torch.Generator().manual_seed(0)
    img, cot = torch.rand(hw + (3,), generator=g), torch.randn(hw + (3,), generator=g)
    relu, branch = torch.relu, []
    out = {}
    for dev in (cuda, "cpu"):
        if dev == "cpu":
            patterns = iter(branch)
            monkeypatch.setattr(torch, "relu", lambda z: z * next(patterns).to(z.dtype))
        else:
            monkeypatch.setattr(torch, "relu", lambda z: branch.append((z > 0).cpu()) or relu(z))
        params = appearance.appearance_params_from_numpy(arrays, dev)
        x = img.to(dev).requires_grad_(True)
        before = (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32)
        with appearance.exact_f32():
            mask = appearance.apply_appearance(params, x, 2)
            grads = torch.autograd.grad((mask * cot.to(dev)).sum(), list(appearance.flatten(params).values()) + [x])
        assert (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == before
        out[str(dev)] = [mask.detach().cpu()] + [gr.cpu() for gr in grads]
    monkeypatch.setattr(torch, "relu", relu)
    (cpu_mask, *cpu_grads), (card_mask, *card_grads) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(card_mask, cpu_mask, rtol=0, atol=1e-5 * float(cpu_mask.abs().max()))
    for a, b in zip(card_grads, cpu_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_ATOL * float(b.abs().max()))


# ---- Scaffold-GS (the port of tests/tpu/test_tpu_scaffold.py) -----------------

SCAFFOLD_POINTS = 60_000
SCAFFOLD_RASTER = RasterConfig(max_tiles_per_gaussian=12)


@pytest.fixture(scope="module")
def scaffold_trainer():
    """A Scaffold-GS trainer at bench shapes: anchors voxelized at 0.25 from
    60k bench means, 2 bench cameras at 1152x864, GT the bench scene's
    renders at SH 0 through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    from dogs_tpu_torch.fields import scaffold

    dev = torch.device("cuda", 0)
    params = synthetic.bench_scene(SCAFFOLD_POINTS, seed=11, device=dev)
    cams = synthetic.bench_cameras(2, device=dev)
    with torch.no_grad():
        gts = [render_tiled(params, c, SCAFFOLD_RASTER, active_sh_degree=0).image for c in cams]
    cfg = scaffold.ScaffoldConfig(max_iterations=100, voxel_size=0.25, stat_start_iter=1, densify_start_iter=10**9)
    return scaffold.ScaffoldGSTrainer(cams, gts, params.xyz.detach().cpu().numpy(), raster_cfg=SCAFFOLD_RASTER,
                                      scaffold_cfg=cfg, device=dev)


def mostly_close(got, want, atol, frac, max_out):
    """tests/tpu/test_tpu_scaffold.py's bar: differences scaled by the
    reference's max."""
    d = (got - want).abs() / (want.abs().max() + 1e-8)
    assert float((d <= atol).float().mean()) >= frac and float(d.max()) <= max_out


def test_scaffold_render_kernels_match_plain(scaffold_trainer):
    """The decode and render through the kernels against the plain blend,
    identical anchors (tests/tpu/test_tpu_scaffold.py's bar)."""
    from dogs_tpu_torch.fields import scaffold

    tr = scaffold_trainer
    counts = blend.blend_forward.launches
    with torch.no_grad():
        got = scaffold.render_scaffold(tr.state.params, tr.cameras[0], SCAFFOLD_RASTER, alive=tr.state.alive)
        want = scaffold.render_scaffold(tr.state.params, tr.cameras[0],
                                        RasterConfig(max_tiles_per_gaussian=12, use_kernel=False),
                                        alive=tr.state.alive)
    assert blend.blend_forward.launches == counts + 1 and got.bin_valid == want.bin_valid > 0
    mostly_close(got.image, want.image, 5e-3, 0.998, 0.1)


def test_scaffold_train_step_at_bench_shapes(scaffold_trainer):
    """One step at bench shapes: a finite loss, nothing dropped by binning,
    anchor_feat moved, each kernel launched once."""
    tr = scaffold_trainer
    before = tr.state.params.anchor_feat.detach().clone()
    launches = [fn.launches for fn in (blend.blend_forward, blend.blend_backward, reduce.sorted_segment_sum)]
    m = tr.train_iteration(tr.state.step + 1)
    assert np.isfinite(float(m["loss"])) and m["bin_dropped"] == 0 and m["bin_pool_truncated"] == 0
    assert [fn.launches for fn in (blend.blend_forward, blend.blend_backward,
                                   reduce.sorted_segment_sum)] == [n + 1 for n in launches]
    assert float((tr.state.params.anchor_feat.detach() - before).abs().max()) > 0


def test_scaffold_decode_on_card_matches_cpu_in_exact_f32(scaffold_trainer):
    """The decode on the card against the CPU at 1e-5 with TF32 switched on
    globally: the MLPs turn it off for themselves (TF32's 10-bit mantissa
    would put them ~1e-3 off)."""
    from dogs_tpu_torch.fields import scaffold

    tr = scaffold_trainer
    arrays = {k: v.detach().cpu().numpy() for k, v in tr.state.params.leaves().items()}
    arrays[".anchor_feat"] = arrays[".anchor_feat"] + np.random.RandomState(0).randn(
        *arrays[".anchor_feat"].shape).astype(np.float32)
    alive = tr.state.alive.cpu()
    cam = tr.cameras[1]
    cam_cpu = dataclasses.replace(cam, **{f: getattr(cam, f).cpu() for f in ("R", "t", "fx", "fy", "cx", "cy")})
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            outs = {}
            for dev, c in ((tr.device, cam), ("cpu", cam_cpu)):
                g, colors, na, aux = scaffold.generate_neural_gaussians(
                    scaffold.scaffold_params_from_numpy(arrays, dev), c, alive=alive.to(dev), with_aux=True)
                outs[str(dev)] = [t.cpu() for t in (g.xyz, g.log_scale, g.quat, g.opacity, colors,
                                                    aux["neural_opacity"])] + [na.cpu()]
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    card, cpu = outs[str(tr.device)], outs["cpu"]
    for a, b in zip(card[:-1], cpu[:-1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    near_zero = (cpu[5].abs() < 1e-6).reshape(-1)
    assert not ((card[-1] != cpu[-1]) & ~near_zero).any()
