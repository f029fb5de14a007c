"""The block partition against dogs_tpu: partition_scene (grid, kmeans,
spectral), the equal-count grid on a tied rig, the box expansion, the box
test at both widths its callers use, the block manifests written by either
package and read by the other, SceneSplitter, and the synthetic preprocess
CLI's blocks_2x2/ tree. Both packages run the same numpy code on the same
numpy inputs, so everything but the rendered images compares exactly."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

import preprocess_large_scale_data as j_preprocess
from dogs_tpu.data import blocks as jblocks
from dogs_tpu.data import splitter as jsplitter
from dogs_tpu.data.dataset import CameraRecord as JCameraRecord
from dogs_tpu.utils.config import load_config as j_load_config
from dogs_tpu_torch import preprocess
from dogs_tpu_torch.data import blocks, splitter
from dogs_tpu_torch.data.dataset import CameraRecord

SMOKE = "config/gaussian_splatting/synthetic_admm_smoke.yaml"
PARTITION_FIELDS = ("transform", "camera_labels", "bounds", "bounds_expanded", "point_bounds",
                    "point_bounds_expanded")


def street_scene(seed=0, n_cams=24, n_points=400):
    """Cameras along a rotated street, points around them (a scene whose OBB
    is not the world frame)."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(-3.0, 3.0, n_cams)
    axis = np.array([np.cos(0.6), np.sin(0.6), 0.0])
    side = np.array([-axis[1], axis[0], 0.0])
    cams = t[:, None] * axis + rng.uniform(-0.8, 0.8, (n_cams, 1)) * side + [0.0, 0.0, 1.5]
    pts = rng.uniform(-3.5, 3.5, (n_points, 1)) * axis + rng.normal(0.0, 1.2, (n_points, 1)) * side
    pts = pts + rng.normal(0.0, 0.3, (n_points, 3))
    return cams, pts.astype(np.float32)


@pytest.mark.parametrize("method", ["grid", "kmeans", "spectral"])
def test_partition_scene_matches_jax(method):
    cams, pts = street_scene()
    got = blocks.partition_scene(cams, pts, 2, 2, (1.4, 1.4), method=method, seed=3)
    want = jblocks.partition_scene(cams, pts, 2, 2, (1.4, 1.4), method=method, seed=3)
    assert got.num_blocks == want.num_blocks == 4
    for f in PARTITION_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for k in range(4):
        np.testing.assert_array_equal(got.point_masks[k], want.point_masks[k])
        np.testing.assert_array_equal(got.crop_bounds(k), want.crop_bounds(k))
        np.testing.assert_array_equal(got.select_bounds(k), want.select_bounds(k))
    assert {int(v) for v in got.camera_labels} == {0, 1, 2, 3}


def test_split_compact_grid_on_a_tied_ring_rig():
    """Two x stations, every y tied within a strip: the rank split still
    gives each of the four blocks cameras, as dogs_tpu's does."""
    x = np.repeat([-1.0, 1.0], 6)
    y = np.tile([0.0, 0.0, 0.0, 2.0, 2.0, 2.0], 2)
    pos = np.stack([x, y, np.zeros(12)], axis=1)
    labels, bounds = blocks.split_compact_grid(pos, 2, 2)
    j_labels, j_bounds = jblocks.split_compact_grid(pos, 2, 2)
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_array_equal(bounds, j_bounds)
    assert np.bincount(labels, minlength=4).tolist() == [3, 3, 3, 3]
    np.testing.assert_array_equal(blocks.split_bipartite(pos, 4), jblocks.split_bipartite(pos, 4))


@pytest.mark.parametrize("factor", [1.4, (1.6, 1.2)])
def test_expand_bounds_matches_jax(factor):
    b = np.random.RandomState(1).randn(4, 2, 2).cumsum(axis=1)
    np.testing.assert_array_equal(blocks.expand_bounds(b, np.asarray(factor)),
                                  jblocks.expand_bounds(b, np.asarray(factor)))


def test_points_in_bounds2d_at_both_widths():
    """Points a few float32 ulps from a box edge: the partition's float64
    test and the master's float32 test (dogs_tpu runs the fusion crop and
    the re-selection on jnp arrays) each equal dogs_tpu's at its width, and
    the two widths disagree on some of them."""
    cams, pts = street_scene(seed=2)
    part = jblocks.partition_scene(cams, pts, 2, 2, (1.4, 1.4))
    T, box = part.transform, part.point_bounds[0]
    rng = np.random.RandomState(4)
    # OBB points on the four edges, moved by up to 8 float32 ulps, then
    # mapped back to the world frame.
    edge = np.concatenate([
        np.stack([np.full(50, box[0, 0]), rng.uniform(box[0, 1], box[1, 1], 50)], 1),
        np.stack([np.full(50, box[1, 0]), rng.uniform(box[0, 1], box[1, 1], 50)], 1),
        np.stack([rng.uniform(box[0, 0], box[1, 0], 50), np.full(50, box[0, 1])], 1),
        np.stack([rng.uniform(box[0, 0], box[1, 0], 50), np.full(50, box[1, 1])], 1),
    ])
    ulp = np.spacing(np.abs(edge).astype(np.float32)).astype(np.float64)
    edge = edge + rng.randint(-8, 9, edge.shape) * ulp
    obb = np.concatenate([edge, rng.uniform(-1.0, 1.0, (200, 1))], axis=1)
    world = ((obb - T[:3, 3]) @ T[:3, :3]).astype(np.float32)

    f64 = blocks.points_in_bounds2d(world, box, T)
    np.testing.assert_array_equal(f64, jblocks.points_in_bounds2d(world, box, T))
    f32 = blocks.points_in_bounds2d_f32(world, box, T)
    j32 = np.asarray(jblocks.points_in_bounds2d(jnp.asarray(world), jnp.asarray(box), jnp.asarray(T)))
    np.testing.assert_array_equal(f32, j32)
    assert (f32 != f64).sum() > 0 and 0 < f32.sum() < len(f32)


def records(cls, n, seed, with_dist):
    rng = np.random.RandomState(seed)
    return [
        cls(R=np.linalg.qr(rng.randn(3, 3))[0], t=rng.randn(3), fx=500.0 + i, fy=510.0, cx=31.5, cy=27.5,
            width=64, height=56, image_path=f"images/{i:03d}.png", image_index=3 * i,
            dist=np.array([0.01 * i, 0.0, 0.001, 0.0]) if with_dist and i % 2 else None)
        for i in range(n)
    ]


@pytest.mark.parametrize("writer", ["port", "dogs_tpu"])
def test_block_manifests_load_in_either_package(tmp_path, writer):
    rng = np.random.RandomState(5)
    pts, cols = rng.randn(30, 3).astype(np.float32), rng.rand(30, 3).astype(np.float32)
    b, be, T = rng.randn(2, 2), rng.randn(2, 2), np.eye(4)
    images = [rng.rand(56, 64, 3).astype(np.float32) for _ in range(3)]
    save, load = (blocks.save_block, jblocks.load_block) if writer == "port" else (jblocks.save_block,
                                                                                    blocks.load_block)
    cls = CameraRecord if writer == "port" else JCameraRecord
    recs = records(cls, 3, 6, with_dist=True)
    save(str(tmp_path), recs, pts, cols, b, be, T, images=images)
    got = load(str(tmp_path))
    for k, v in dict(points=pts, colors=cols, bounds=b, bounds_expanded=be, transform=T).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for a, r in zip(got["images"], images):
        np.testing.assert_array_equal(a, r.astype(np.float16).astype(np.float32))
    for g, r in zip(got["cameras"], recs):
        for f in ("R", "t", "fx", "fy", "cx", "cy", "width", "height", "image_path", "image_index"):
            np.testing.assert_array_equal(getattr(g, f), getattr(r, f), err_msg=f)
        assert (g.dist is None) == (r.dist is None)
        if r.dist is not None:
            np.testing.assert_array_equal(g.dist, r.dist)


@pytest.mark.parametrize("split_type", ["camera", "point"])
def test_scene_splitter_matches_jax(tmp_path, split_type):
    rng = np.random.RandomState(8)
    c2w = np.tile(np.eye(4), (20, 1, 1))
    c2w[:, :3, 3] = rng.randn(20, 3) * [3.0, 1.0, 0.2]
    pts = rng.randn(60, 3)
    ids = [rng.choice(20, 3, replace=False) for _ in range(60)]
    kw = dict(camtoworlds=c2w, points3d=pts, split_type=split_type, num_blocks=3, seed=2)
    got = splitter.SceneSplitter(ids).split(save_dir=str(tmp_path / "port"), **kw)
    want = jsplitter.SceneSplitter(ids).split(save_dir=str(tmp_path / "jax"), **kw)
    assert got == want
    assert (tmp_path / "port" / "cluster.txt").read_text() == (tmp_path / "jax" / "cluster.txt").read_text()


def test_synthetic_preprocess_tree_equals_dogs_tpu(tmp_path):
    """python -m dogs_tpu_torch.preprocess against preprocess_scene on the
    synthetic smoke scene: the same files, every array equal but the images
    (each package renders its own, stored as float16) within 1e-3."""
    overrides = ["dataset.n_cams=16", "dataset.width=48", "dataset.height=40", "dataset.n_gaussians=64"]
    preprocess.main(["--config", SMOKE, f"dataset.root_dir={tmp_path}/port", "device=cpu", *overrides])
    j_cfg = j_load_config(SMOKE, cli_overrides=[f"dataset.root_dir={tmp_path}/jax", *overrides])
    j_preprocess.preprocess_scene(j_cfg, "toy_blocks")
    port, ref = tmp_path / "port" / "toy_blocks" / "blocks_2x2", tmp_path / "jax" / "toy_blocks" / "blocks_2x2"
    files = sorted(str(p.relative_to(ref)) for p in ref.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(port)) for p in port.rglob("*") if p.is_file())
    assert len(files) == 3 + 4 * 3
    for name in files:
        a, b = port / name, ref / name
        if name.endswith(".txt"):
            np.testing.assert_array_equal(np.loadtxt(a), np.loadtxt(b), err_msg=name)
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=name)
        elif name.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), name
        else:
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files), name
                for k in x.files:
                    assert x[k].dtype == y[k].dtype, (name, k)
                    if k == "images":
                        np.testing.assert_allclose(x[k].astype(np.float32), y[k].astype(np.float32), atol=1e-3)
                    elif k == "colors":
                        np.testing.assert_allclose(x[k], y[k], rtol=0, atol=1e-6, err_msg=name)
                    else:
                        np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name} {k}")
    assert os.path.getsize(port / "block_0" / "block.npz") > 0
