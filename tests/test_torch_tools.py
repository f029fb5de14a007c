"""The last JAX-free modules of the port against dogs_tpu: the rest of
core/transforms.py, core/align.py, the native COLMAP parser, .ksplat export
and import with the create_ksplat tool, the two dataset converters, the
dense reference render, and utils/visualization.py. The same numpy inputs
go to both packages; file writers are held to dogs_tpu's bytes."""

import importlib.util
import json
import struct
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.core import align as jalign
from dogs_tpu.core import transforms as jtf
from dogs_tpu.core.camera import look_at_camera as j_look_at
from dogs_tpu.data import native as jnative
from dogs_tpu.fields import io as jio
from dogs_tpu.raster.reference import render_reference as j_render_reference
from dogs_tpu.utils import visualization as jvis
from dogs_tpu_torch.core import align, look_at_camera, params_from_numpy
from dogs_tpu_torch.core import transforms as ttf
from dogs_tpu_torch.data import colmap, native, synthetic
from dogs_tpu_torch.data.ply import write_point_cloud
from dogs_tpu_torch.fields import io as tio
from dogs_tpu_torch.raster.binning import build_tile_bins
from dogs_tpu_torch.raster.projection import project_gaussians
from dogs_tpu_torch.raster.reference import render_reference
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled
from dogs_tpu_torch.tools import create_ksplat, matrix_city_to_colmap, meganerf_to_colmap
from dogs_tpu_torch.utils import visualization
from tests.test_native_colmap import write_images_with_obs, write_points3d_with_tracks
from tests.test_torch_core import jax_params

FWD_ATOL = 3e-4  # forward parity bar of tests/test_pallas_blend.py
ROOT = Path(__file__).resolve().parents[1]


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def load_script(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- transforms -------------------------------------------------------------------


def rotations(n, seed):
    """Random rotations (float32, through dogs_tpu's quat_to_rotmat), then
    rotations within 1e-3 rad of 180 degrees about random axes, where the
    trace is about -1 and a diagonal pivot takes over."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4)
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = np.pi - rng.rand(n) * 1e-3
    q180 = np.concatenate([np.cos(theta / 2)[:, None], np.sin(theta / 2)[:, None] * axis], 1)
    return np.asarray(jtf.quat_to_rotmat(jnp.asarray(np.concatenate([q, q180]), jnp.float32)))


def test_rotmat_to_quat_equals_dogs_tpu_bit_for_bit_and_round_trips():
    """Bit for bit against dogs_tpu's eager float32 (the converters' bytes
    depend on it), and quat -> rotmat -> quat recovers the rotation."""
    R = np.array(rotations(2000, 0))
    got = np_(ttf.rotmat_to_quat(torch.from_numpy(R)))
    np.testing.assert_array_equal(got, np.asarray(jtf.rotmat_to_quat(jnp.asarray(R))))
    back = np_(ttf.quat_to_rotmat(torch.from_numpy(got)))
    np.testing.assert_allclose(back, R, atol=2e-6)
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_quaternion_and_covariance_helpers_match_dogs_tpu():
    rng = np.random.RandomState(1)
    a, b = rng.randn(64, 4).astype(np.float32), rng.randn(64, 4).astype(np.float32)
    v, scale = rng.randn(64, 3).astype(np.float32), np.exp(rng.randn(64, 3)).astype(np.float32)
    t = {k: torch.from_numpy(x) for k, x in dict(a=a, b=b, v=v, s=scale).items()}
    pairs = [
        (ttf.quat_multiply(t["a"], t["b"]), jtf.quat_multiply(jnp.asarray(a), jnp.asarray(b))),
        (ttf.quat_rotate(t["a"], t["v"]), jtf.quat_rotate(jnp.asarray(a), jnp.asarray(v))),
        (ttf.build_covariance_3d(t["s"], t["a"]), jtf.build_covariance_3d(jnp.asarray(scale), jnp.asarray(a))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    cov = ttf.build_covariance_3d(t["s"], t["a"])
    six = ttf.covariance_to_symmetric6(cov)
    np.testing.assert_array_equal(np_(six), np.asarray(jtf.covariance_to_symmetric6(jnp.asarray(np_(cov)))))
    np.testing.assert_array_equal(np_(ttf.symmetric6_to_covariance(six)), np_(cov))  # cov is exactly symmetric
    np.testing.assert_array_equal(np_(ttf.symmetric6_to_covariance(six)),
                                  np.asarray(jtf.symmetric6_to_covariance(jnp.asarray(np_(six)))))
    # A rotation by q then its inverse, and q * conj(q) = identity.
    conj = t["a"] * torch.tensor([1.0, -1.0, -1.0, -1.0])
    np.testing.assert_allclose(np_(ttf.quat_rotate(conj, ttf.quat_rotate(t["a"], t["v"]))), v, atol=1e-5)
    unit = ttf.normalize(t["a"])
    ident = ttf.quat_multiply(unit, unit * torch.tensor([1.0, -1.0, -1.0, -1.0]))
    np.testing.assert_allclose(np_(ident), np.tile([1.0, 0, 0, 0], (64, 1)), atol=1e-6)
    # The covariance's 6 components equal projection's scalarized form.
    np.testing.assert_allclose(np_(six), np_(torch.stack(ttf.covariance_sym6(t["s"], t["a"]), -1)),
                               rtol=1e-5, atol=1e-6)


# ---- align --------------------------------------------------------------------------


def trajectories(seed):
    """A camera-to-world trajectory and its image under a known sim(3), with
    noise on the centres."""
    rng = np.random.RandomState(seed)
    R = rotations(12, seed)[:12].astype(np.float64)
    est = np.concatenate([R, rng.randn(12, 3, 1)], axis=2)
    s, Rg = 1.7, rotations(1, seed + 1)[0].astype(np.float64)
    tg = rng.randn(3)
    gt = np.concatenate([Rg[None] @ est[:, :, :3], s * (Rg[None] @ est[:, :, 3:]) + tg[None, :, None]], axis=2)
    gt[:, :, 3] += rng.randn(12, 3) * 1e-3
    return est, gt, (s, Rg, tg)


@pytest.mark.parametrize("seed", [0, 1])
def test_align_functions_equal_dogs_tpu(seed):
    est, gt, (s, Rg, tg) = trajectories(seed)
    np.testing.assert_array_equal(align.convert3x4_4x4(est), jalign.convert3x4_4x4(est))
    np.testing.assert_array_equal(align.convert3x4_4x4(est[0]), jalign.convert3x4_4x4(est[0]))
    for known in (False, True):
        for a, b in zip(align.align_umeyama(gt[:, :, 3], est[:, :, 3], known),
                        jalign.align_umeyama(gt[:, :, 3], est[:, :, 3], known)):
            np.testing.assert_array_equal(a, b)
    got = align.align_sim3(est[:, :, 3], gt[:, :, 3])
    for a, b in zip(got, jalign.align_sim3(est[:, :, 3], gt[:, :, 3])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], s, rtol=1e-3)
    np.testing.assert_allclose(got[1], Rg, atol=1e-3)
    c = np.random.RandomState(seed).randn(3, 3)
    assert align.get_best_yaw(c) == jalign.get_best_yaw(c)
    with pytest.raises(ValueError):
        align.get_best_yaw(np.eye(4))
    for a, b in zip(align.align_ate_c2b_use_a2b(est, gt), jalign.align_ate_c2b_use_a2b(est, gt)):
        np.testing.assert_array_equal(a, b)
    ate = align.absolute_trajectory_error(est, gt)
    assert ate == jalign.absolute_trajectory_error(est, gt) and ate["ate_rmse"] < 5e-3
    assert align.absolute_trajectory_error(est, gt, align=False) == jalign.absolute_trajectory_error(est, gt, False)


# ---- the native COLMAP parser -----------------------------------------------------------


@pytest.fixture
def native_lib():
    lib = native.load()
    if lib is None:
        pytest.skip("no C toolchain in this environment")
    return lib


def test_native_parser_equals_numpy_and_dogs_tpu(tmp_path, native_lib, caplog):
    rng = np.random.RandomState(0)
    n = 700
    xyz, rgb = rng.randn(n, 3), rng.randint(0, 256, (n, 3)).astype(np.uint8)
    err, tracks = rng.rand(n), rng.randint(0, 9, n)
    pts, imgs = str(tmp_path / "points3D.bin"), str(tmp_path / "images.bin")
    write_points3d_with_tracks(pts, xyz, rgb, err, tracks, rng)
    names = write_images_with_obs(imgs, 40, rng)
    caplog.set_level("INFO")
    fast = colmap.read_points3d_bin(pts)
    assert f"{pts}: read by the native parser" in caplog.text
    for a, b, c, want in zip(fast, colmap.read_points3d_bin_numpy(pts), jnative.read_points3d_bin_fast(pts),
                             (xyz, rgb, err)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, want)
    got, slow, theirs = colmap.read_images_bin(imgs), colmap.read_images_bin_numpy(imgs), jnative.read_images_bin_fast(imgs)
    assert list(got) == list(slow) == list(theirs) == list(range(1, 41))
    for iid, im in got.items():
        q, t, cid, name = theirs[iid]
        assert (im.camera_id, im.name) == (slow[iid].camera_id, slow[iid].name) == (cid, name)
        assert name == names[iid - 1]
        for a, b in ((im.qvec, q), (im.tvec, t), (im.qvec, slow[iid].qvec), (im.tvec, slow[iid].tvec)):
            np.testing.assert_array_equal(a, b)


def test_truncated_or_corrupt_files_raise(tmp_path, native_lib):
    rng = np.random.RandomState(2)
    path = tmp_path / "points3D.bin"
    write_points3d_with_tracks(str(path), rng.randn(10, 3), rng.randint(0, 255, (10, 3)).astype(np.uint8),
                               rng.rand(10), rng.randint(1, 5, 10), rng)
    data = path.read_bytes()
    path.write_bytes(data[:-9])  # ends inside the last record
    with pytest.raises(ValueError, match="truncated"):
        colmap.read_points3d_bin(str(path))
    path.write_bytes(data[:51] + struct.pack("<Q", 2**62) + data[59:])  # the first track length past the end
    with pytest.raises(ValueError, match="truncated"):
        colmap.read_points3d_bin(str(path))
    path.write_bytes(struct.pack("<Q", 10**9) + data[8:])  # more records than bytes
    with pytest.raises(ValueError, match="cannot fit"):
        colmap.read_points3d_bin(str(path))
    imgs = tmp_path / "images.bin"
    write_images_with_obs(str(imgs), 5, rng)
    imgs.write_bytes(imgs.read_bytes()[:-3])
    with pytest.raises(ValueError, match="truncated"):
        colmap.read_images_bin(str(imgs))


# ---- .ksplat --------------------------------------------------------------------------


def splat_model(n=3000, seed=0):
    """A model spread over several 5-unit cells (full and partial buckets)
    with dead slots."""
    rng = np.random.RandomState(seed)
    arrays = dict(xyz=(rng.randn(n, 3) * 8).astype(np.float32), feat_dc=rng.randn(n, 1, 3).astype(np.float32),
                  feat_rest=(rng.randn(n, 15, 3) * 0.1).astype(np.float32),
                  log_scale=(rng.randn(n, 3) - 3).astype(np.float32), quat=rng.randn(n, 4).astype(np.float32),
                  logit_opacity=rng.randn(n, 1).astype(np.float32))
    arrays["xyz"][:600] = rng.rand(600, 3).astype(np.float32) * 4.0  # one cell: two full buckets and a part
    return arrays, rng.rand(n) > 0.2


def test_ksplat_bytes_and_read_back_equal_dogs_tpu(tmp_path):
    arrays, alive = splat_model()
    jio.save_ksplat(str(tmp_path / "j.ksplat"), jax_params(arrays), jnp.asarray(alive))
    tio.save_ksplat(str(tmp_path / "t.ksplat"), params_from_numpy(arrays, "cpu"), torch.from_numpy(alive))
    assert (tmp_path / "t.ksplat").read_bytes() == (tmp_path / "j.ksplat").read_bytes()
    got, want = tio.load_ksplat(str(tmp_path / "t.ksplat")), jio.load_ksplat(str(tmp_path / "j.ksplat"))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["xyz"].shape == (int(alive.sum()), 3)
    # Centres come back within half a quantization step of 2.5 / 32767.
    np.testing.assert_allclose(np.sort(got["xyz"], axis=0), np.sort(arrays["xyz"][alive], axis=0), atol=4e-5)


def test_create_ksplat_equals_the_script(tmp_path, monkeypatch, capsys):
    """From a .ply the bytes equal tools/create_ksplat.py's. From a .splat
    they differ only in opacity bytes, by one level where alpha sits on a
    byte boundary: dogs_tpu takes the logit with XLA's log, the port with
    PyTorch's (a divergence: ROADMAP.md queue 3)."""
    arrays, alive = splat_model(seed=1)
    params = params_from_numpy(arrays, "cpu")
    tio.save_gaussian_ply(str(tmp_path / "m.ply"), params, torch.from_numpy(alive))
    tio.save_splat(str(tmp_path / "m.splat"), params, torch.from_numpy(alive))
    script = load_script(ROOT / "tools" / "create_ksplat.py")
    outs = {}
    for src in ("m.ply", "m.splat"):
        monkeypatch.setattr(sys, "argv", ["create_ksplat.py", str(tmp_path / src), str(tmp_path / f"j_{src}.ksplat")])
        script.main()
        create_ksplat.main([str(tmp_path / src), str(tmp_path / f"t_{src}.ksplat")])
        outs[src] = [np.fromfile(tmp_path / f"{p}_{src}.ksplat", np.uint8) for p in "tj"]
    create_ksplat.main([str(tmp_path / "m.ply")])  # default output: the input's stem
    assert (tmp_path / "m.ksplat").read_bytes() == outs["m.ply"][0].tobytes()
    assert "m.ply -> " in capsys.readouterr().out
    np.testing.assert_array_equal(*outs["m.ply"])
    got, want = outs["m.splat"]
    assert got.shape == want.shape
    n = int(alive.sum())
    records = slice(got.size - 24 * n, got.size)
    np.testing.assert_array_equal(got[: records.start], want[: records.start])
    rec_t, rec_j = got[records].reshape(n, 24), want[records].reshape(n, 24)
    np.testing.assert_array_equal(rec_t[:, :23], rec_j[:, :23])
    d = rec_t[:, 23].astype(int) - rec_j[:, 23]
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 0.05
    with pytest.raises(SystemExit):
        create_ksplat.main([str(tmp_path / "m.txt")])


# ---- the converters --------------------------------------------------------------------


def meganerf_scene(root):
    """tests/test_converters.py's Mega-NeRF fixture: 4 train and 2 val
    metadata files of random DRB poses and a mappings.txt."""
    scene = root / "rubble"
    rng = np.random.RandomState(0)
    names = []
    for split, count in [("train", 4), ("val", 2)]:
        md = scene / split / "metadata"
        md.mkdir(parents=True)
        for i in range(count):
            q = rng.randn(4)
            w, x, y, z = q / np.linalg.norm(q)
            R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                          [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                          [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
            c2w = np.concatenate([R, rng.randn(3, 1)], axis=1)
            torch.save({"c2w": torch.tensor(c2w, dtype=torch.float32),
                        "intrinsics": torch.tensor([500.0, 500.0, 320.0, 240.0]), "W": 640, "H": 480},
                       md / f"{split}_{i:03d}.pt")
            names.append((f"{split}_{i:03d}", f"{split}_{i:03d}.jpg"))
    (scene / "mappings.txt").write_text("".join(f"{img},{meta}\n" for meta, img in names))
    return scene


def matrix_city_scene(root, with_cloud):
    """tests/test_converters.py's MatrixCity fixture: 5 frames rotated about
    z, and optionally a dense point cloud to downsample."""
    scene = root / "small_city"
    scene.mkdir()
    rng = np.random.RandomState(1)
    frames = []
    for i in range(5):
        c2w = np.eye(4)
        th = rng.rand() * 2 * np.pi
        c2w[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        c2w[:3, 3] = rng.randn(3)
        frames.append({"file_path": f"../../aerial/block_1/im_{i}.png", "transform_matrix": c2w.tolist()})
    meta = {"fl_x": 400.0, "fl_y": 400.0, "cx": 250.0, "cy": 250.0, "w": 500, "h": 500, "frames": frames}
    (scene / "transforms.json").write_text(json.dumps(meta))
    if with_cloud:
        write_point_cloud(str(scene / "point_cloud.ply"), rng.randn(400, 3) * 3, rng.rand(400, 3))
    return scene


def assert_same_files(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_meganerf_converter_writes_the_script_bytes(tmp_path):
    script = load_script(ROOT / "scripts" / "preprocess" / "meganerf_to_colmap.py")
    for who in ("j", "t"):
        meganerf_scene(tmp_path / who)
    script.convert(str(tmp_path / "j"), "rubble")
    meganerf_to_colmap.convert(str(tmp_path / "t"), "rubble")
    j, t = tmp_path / "j" / "rubble", tmp_path / "t" / "rubble"
    assert_same_files(j, t, ["sparse/0/cameras.bin", "sparse/0/images.bin", "sparse/0/points3D.bin",
                             "val_images.txt"])
    model = colmap.load_model(str(t / "sparse" / "0"))
    assert len(model.images) == 6 and model.cameras[1].fx == 500.0


@pytest.mark.parametrize("with_cloud", [False, True], ids=["camera_centres", "point_cloud"])
def test_matrix_city_converter_writes_the_script_bytes(tmp_path, with_cloud):
    script = load_script(ROOT / "scripts" / "preprocess" / "matrix_city_to_colmap.py")
    for who in ("j", "t"):
        (tmp_path / who).mkdir()
        matrix_city_scene(tmp_path / who, with_cloud)
    script.convert(str(tmp_path / "j" / "small_city"))
    matrix_city_to_colmap.convert(str(tmp_path / "t" / "small_city"))
    j, t = tmp_path / "j" / "small_city", tmp_path / "t" / "small_city"
    assert_same_files(j, t, ["sparse/0/cameras.bin", "sparse/0/images.bin", "sparse/0/points3D.bin"])
    model = colmap.load_model(str(t / "sparse" / "0"))
    assert model.images[1].name == "aerial/block_1/im_0.png"
    assert (model.points_xyz.shape[0] > 5) == with_cloud


# ---- the dense reference render -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_render_reference_matches_dogs_tpu_and_the_tiled_render(seed):
    """The dense oracle against dogs_tpu's (no tile support), and, with the
    port's binned tiles as each Gaussian's support, against render_tiled at
    the forward bar; its gradient reaches every parameter."""
    arrays = synthetic.random_scene_arrays(seed=seed)
    view = synthetic.RANDOM_SCENE_VIEW
    bg = np.array([0.15, 0.25, 0.35], np.float32)
    want = j_render_reference(jax_params(arrays), j_look_at(**view), background=jnp.asarray(bg), active_sh_degree=2)
    params = params_from_numpy(arrays, "cpu")
    cam = look_at_camera(**view, device="cpu")
    got = render_reference(params, cam, background=torch.from_numpy(bg), active_sh_degree=2)
    for f in ("image", "alpha", "invdepth"):
        np.testing.assert_allclose(np_(getattr(got, f)), np.asarray(getattr(want, f)), atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(np_(got.radii), np.asarray(want.radii))
    cfg = RasterConfig(max_tiles_per_gaussian=36)
    with torch.no_grad():
        bins = build_tile_bins(project_gaussians(params, cam, active_sh_degree=2), view["height"], view["width"],
                               max_tiles_per_gaussian=36)
        member = torch.zeros((int(bins.tile_starts.shape[0]) - 1, params.capacity), dtype=torch.bool)
        member[bins.sorted_tile.long(), bins.sorted_idx.long()] = True
        tiled = render_tiled(params, cam, cfg, background=torch.from_numpy(bg), active_sh_degree=2)
    ref = render_reference(params, cam, background=torch.from_numpy(bg), active_sh_degree=2, tile_membership=member)
    for f in ("image", "alpha", "invdepth"):
        np.testing.assert_allclose(np_(getattr(ref, f)), np_(getattr(tiled, f)), atol=FWD_ATOL, err_msg=f)
    grads = torch.autograd.grad(ref.image.sum(), [params.xyz, params.feat_dc, params.logit_opacity])
    assert all(bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0) for g in grads)


# ---- visualization ------------------------------------------------------------------------


def test_colorize_depth_equals_dogs_tpu_and_needs_no_matplotlib(monkeypatch):
    rng = np.random.RandomState(0)
    depth = (rng.rand(48, 64) * 5).astype(np.float32)
    depth[rng.rand(48, 64) < 0.1] = 0.0
    want = jvis.colorize_depth(depth)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib now raises
    got = visualization.colorize_depth(depth)
    np.testing.assert_array_equal(got, want)
    assert (got[depth == 0] == 0).all()
    np.testing.assert_array_equal(visualization.colorize_depth(np.zeros((4, 4))), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ImportError, match="matplotlib"):
        visualization.plot_cameras(np.tile(np.eye(4), (2, 1, 1)))


def test_plots_are_written(tmp_path):
    pytest.importorskip("matplotlib")
    est, _, _ = trajectories(0)
    c2ws = align.convert3x4_4x4(est)
    labels = np.arange(12) % 4
    out = visualization.plot_cameras(c2ws, labels, points=np.random.RandomState(0).randn(200, 3),
                                     path=str(tmp_path / "cams.png"))
    bounds = np.array([[[-2, -2], [0, 0]], [[0, -2], [2, 0]], [[-2, 0], [0, 2]], [[0, 0], [2, 2]]], np.float64)
    blocks_png = visualization.plot_blocks(c2ws[:, :3, 3], labels, bounds, np.eye(4), path=str(tmp_path / "b.png"))
    for path in (out, blocks_png):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
