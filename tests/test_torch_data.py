"""The data slice against dogs_tpu: COLMAP readers and writers, the PNG
decoder, `load_image`, `load_scene` with its split and normalisation rules,
the minify and undistort caches, and the lazy image reader. COLMAP models are
written with dogs_tpu's writers and images with imageio or PIL, all from
seeded numpy, in tmp_path."""

import dataclasses
import os
import shutil
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from dogs_tpu.core.transforms import rotmat_to_quat
from dogs_tpu.data import colmap as jcolmap
from dogs_tpu.data import dataset as jdataset
from dogs_tpu_torch.data import colmap as tcolmap
from dogs_tpu_torch.data import dataset as tdataset
from dogs_tpu_torch.data.reader import LazyImageList
from dogs_tpu_torch.utils import png

LEVEL = 1.0 / 255.0  # one 8-bit level


def write_scene(root, n_images=6, w=64, h=48, model="PINHOLE", params=None, image_names=None, seed=0,
                images=None, n_points=50):
    """A COLMAP scene on disk: cameras looking at the origin from a ring with
    random tilts, PNG images (random, or `images`), random points."""
    rng = np.random.RandomState(seed)
    model_dir = os.path.join(root, "sparse", "0")
    os.makedirs(model_dir, exist_ok=True)
    params = [0.9 * w, 0.9 * w, w / 2, h / 2] if params is None else params
    cameras = {1: jcolmap.ColmapCamera(1, model, w, h, np.asarray(params, np.float64))}
    img_dir = os.path.join(root, "images")
    names = image_names or [f"im_{i:03d}.png" for i in range(n_images)]
    entries = {}
    for i, name in enumerate(names):
        a = 2 * np.pi * i / len(names)
        eye = np.array([4.0 * np.sin(a), -0.5 + 0.2 * rng.randn(), -4.0 * np.cos(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, -1.0, 0.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])  # world -> camera rows
        q = np.asarray(rotmat_to_quat(R.astype(np.float32)), np.float64)
        entries[i + 1] = jcolmap.ColmapImage(i + 1, q, -R @ eye, 1, name)
        arr = images[i] if images is not None else (rng.rand(h, w, 3) * 255).astype(np.uint8)
        os.makedirs(os.path.dirname(os.path.join(img_dir, name)), exist_ok=True)
        imageio.imwrite(os.path.join(img_dir, name), arr)
    jcolmap.write_cameras_bin(os.path.join(model_dir, "cameras.bin"), cameras)
    jcolmap.write_images_bin(os.path.join(model_dir, "images.bin"), entries)
    pts = rng.randn(n_points, 3)
    rgb = (rng.rand(n_points, 3) * 255).astype(np.uint8)
    jcolmap.write_points3d_bin(os.path.join(model_dir, "points3D.bin"), pts, rgb)
    return root


# ---- COLMAP --------------------------------------------------------------------


def write_observed_model(d, rng):
    """cameras / images / points3D .bin with 2D observations and tracks
    (dogs_tpu's writers leave both empty), written with struct."""
    cams = {1: jcolmap.ColmapCamera(1, "OPENCV", 640, 480, rng.randn(8)),
            3: jcolmap.ColmapCamera(3, "SIMPLE_RADIAL", 320, 240, rng.randn(4))}
    jcolmap.write_cameras_bin(os.path.join(d, "cameras.bin"), cams)
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 3))
        for iid, n_obs in ((2, 5), (7, 0), (9, 3)):
            f.write(struct.pack("<i", iid) + rng.randn(7).tobytes() + struct.pack("<i", 1 + 2 * (iid % 2)))
            f.write(f"dir/img_{iid}.png".encode() + b"\x00" + struct.pack("<Q", n_obs))
            f.write(rng.randn(n_obs * 3).tobytes())  # (x, y, p3d_id) per observation, 24 bytes
    n = 200
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            track = int(rng.randint(0, 6))
            rgb = rng.randint(0, 256, 3).astype(np.uint8)
            f.write(struct.pack("<Q", i + 7) + rng.randn(3).tobytes() + rgb.tobytes())
            observations = rng.randint(0, 99, 2 * track).astype("<i4")  # (image_id, p2d_idx) x track
            f.write(struct.pack("<d", rng.rand()) + struct.pack("<Q", track) + observations.tobytes())


def assert_models_equal(t, j):
    assert list(t.cameras) == list(j.cameras) and list(t.images) == list(j.images)
    for k, c in j.cameras.items():
        tc = t.cameras[k]
        assert (tc.camera_id, tc.model, tc.width, tc.height) == (c.camera_id, c.model, c.width, c.height)
        np.testing.assert_array_equal(tc.params, c.params)
        assert (tc.fx, tc.fy, tc.cx, tc.cy) == (c.fx, c.fy, c.cx, c.cy)
    for k, im in j.images.items():
        ti = t.images[k]
        assert (ti.image_id, ti.camera_id, ti.name) == (im.image_id, im.camera_id, im.name)
        np.testing.assert_array_equal(ti.qvec, im.qvec)
        np.testing.assert_array_equal(ti.tvec, im.tvec)
        np.testing.assert_array_equal(ti.rotation(), im.rotation())
    for a, b in ((t.points_xyz, j.points_xyz), (t.points_rgb, j.points_rgb), (t.points_err, j.points_err)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["bin", "txt", "bin_with_tracks"])
def test_colmap_readers_equal_dogs_tpu(tmp_path, fmt):
    rng = np.random.RandomState(4)
    if fmt == "bin_with_tracks":
        write_observed_model(str(tmp_path), rng)
    else:
        cams = {1: jcolmap.ColmapCamera(1, "PINHOLE", 64, 48, rng.rand(4) * 50),
                2: jcolmap.ColmapCamera(2, "RADIAL", 32, 24, rng.rand(5))}
        images = {i: jcolmap.ColmapImage(i, rng.randn(4), rng.randn(3), 1 + i % 2, f"a/{i}.png") for i in (1, 4, 5)}
        xyz, rgb = rng.randn(30, 3), rng.randint(0, 256, (30, 3)).astype(np.uint8)
        if fmt == "bin":
            jcolmap.write_cameras_bin(str(tmp_path / "cameras.bin"), cams)
            jcolmap.write_images_bin(str(tmp_path / "images.bin"), images)
            jcolmap.write_points3d_bin(str(tmp_path / "points3D.bin"), xyz, rgb)
        else:
            jcolmap.write_model_txt(str(tmp_path), cams, images, xyz, rgb)
    assert_models_equal(tcolmap.load_model(str(tmp_path)), jcolmap.load_model(str(tmp_path)))


def test_colmap_writers_equal_dogs_tpu(tmp_path):
    rng = np.random.RandomState(5)
    cams = {2: tcolmap.ColmapCamera(2, "OPENCV", 64, 48, rng.randn(8))}
    images = {i: tcolmap.ColmapImage(i, rng.randn(4), rng.randn(3), 2, f"{i}.jpg") for i in (3, 1)}
    xyz, rgb, err = rng.randn(40, 3), rng.randint(0, 256, (40, 3)).astype(np.uint8), rng.rand(40)
    for mod, d in ((tcolmap, tmp_path / "t"), (jcolmap, tmp_path / "j")):
        os.makedirs(d)
        mod.write_cameras_bin(str(d / "cameras.bin"), cams)
        mod.write_images_bin(str(d / "images.bin"), images)
        mod.write_points3d_bin(str(d / "points3D.bin"), xyz, rgb, err)
        mod.write_model_txt(str(d / "txt"), cams, images, xyz, rgb)
    for name in ("cameras.bin", "images.bin", "points3D.bin", "txt/cameras.txt", "txt/images.txt",
                 "txt/points3D.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


# ---- PNG decoding --------------------------------------------------------------


PIL_MODES = {
    "grey": ("L", (20, 33)),
    "grey_alpha": ("LA", (20, 33, 2)),
    "rgb": ("RGB", (20, 33, 3)),
    "rgba": ("RGBA", (20, 33, 4)),
    "grey16": ("I;16", (20, 33)),
}


@pytest.mark.parametrize("kind", list(PIL_MODES) + ["palette", "palette_alpha", "palette_4bit"])
def test_png_decoder_equals_imageio_on_pil_files(tmp_path, kind):
    """Files saved by PIL (whose encoder picks each row's filter type; it
    packs a palette of up to 16 colours at 4 bits)."""
    rng = np.random.RandomState(len(kind))
    path = str(tmp_path / f"{kind}.png")
    if kind.startswith("palette"):
        n = 7 if kind == "palette_4bit" else 40
        idx = rng.randint(0, n, (21, 17)).astype(np.uint8)
        im = Image.fromarray(idx, "P")
        im.putpalette(list(rng.randint(0, 256, n * 3)))
        if kind == "palette_alpha":
            im.info["transparency"] = bytes(rng.randint(0, 256, 5).astype(np.uint8))
        im.save(path)
    else:
        mode, shape = PIL_MODES[kind]
        if mode == "I;16":
            arr = rng.randint(0, 65536, shape).astype(np.uint16)
        else:  # smooth ramps plus noise: PIL picks several filter types
            ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3
            arr = (ramp.reshape(shape[:2] + (1,) * (len(shape) - 2)) + rng.randint(0, 40, shape)).astype(np.uint8)
        (Image.fromarray(arr) if mode == "I;16" else Image.fromarray(arr, mode)).save(path)
    want = imageio.imread(path)
    got = png.read_png(path)
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def filter_rows(raw: np.ndarray, bpp: int, filters) -> bytes:
    """PNG's filtered rows of the (h, stride) bytes `raw`: row y with filter
    type filters[y % len], `bpp` bytes to the byte on the left."""
    raw = raw.astype(np.int64)
    rows = []
    for y in range(raw.shape[0]):
        f = filters[y % len(filters)]
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])[:cur.size]
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])[:cur.size]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(rows)


def png_file(header: tuple, idat: bytes, palette: np.ndarray | None = None) -> bytes:
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    plte = chunk(b"PLTE", palette.astype(np.uint8).tobytes()) if palette is not None else b""
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", *header)) + plte
            + chunk(b"IDAT", zlib.compress(idat)) + chunk(b"IEND", b""))


def sample_bytes(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples as PNG row bytes (h, stride): big-endian 16-bit, or
    sub-byte indices packed from the high bits."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth < 8:
        bits = ((samples.reshape(h, -1)[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
        return np.packbits(bits.astype(np.uint8), axis=1)
    return samples.reshape(h, -1).astype(np.uint8)


def filtered_png(img: np.ndarray, filters) -> bytes:
    """An 8- or 16-bit PNG whose row y uses filter type filters[y % len]."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 * img.dtype.itemsize
    raw = sample_bytes(img.reshape(h, w, c), depth)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return png_file((w, h, depth, ctype, 0, 0, 0), filter_rows(raw, c * depth // 8, filters))


def adam7_png(samples: np.ndarray, depth: int, ctype: int, palette: np.ndarray | None = None,
              filters=(0, 1, 2, 3, 4)) -> bytes:
    """An interlaced PNG of (h, w, c) samples (palette indices for colour
    type 3): Adam7's seven passes, each filtered on its own, rows cycling
    through `filters`; an empty pass has no bytes."""
    h, w, c = samples.shape
    idat = b""
    for x0, y0, dx, dy in png.ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            idat += filter_rows(sample_bytes(sub, depth), max(c * depth // 8, 1), filters)
    return png_file((w, h, depth, ctype, 0, 0, 1), idat, palette)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decoder_equals_imageio_on_every_filter_type(tmp_path, depth, channels):
    rng = np.random.RandomState(depth + channels)
    dtype = np.uint8 if depth == 8 else np.uint16
    shape = (11, 9) if channels == 1 else (11, 9, channels)
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(filtered_png(img, [0, 1, 2, 3, 4, 4, 3, 1]))
    want = imageio.imread(path)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, img)
    if depth == 8 or channels == 1:
        np.testing.assert_array_equal(want, img)
    else:  # PIL keeps 16 bits only for grey: imageio returns the high bytes
        high = (img >> 8).astype(np.uint8)
        if channels == 2:  # as RGBA
            high = np.concatenate([high[..., :1].repeat(3, -1), high[..., 1:]], -1)
        np.testing.assert_array_equal(want, high)
    # The port's writer round-trips every layout it writes.
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_decoder_rejects_interlaced_files(tmp_path):
    """An interlaced file decodes by its seven passes (equal to its array and
    to imageio's decode); a file whose IHDR says Adam7 over plain rows
    raises naming the file (its passes' bytes fall out of step: here a data
    byte where a pass row's filter type belongs)."""
    img = np.random.RandomState(2).randint(0, 256, (4, 4, 3)).astype(np.uint8)
    path = tmp_path / "adam7.png"
    path.write_bytes(adam7_png(img, 8, 2))
    np.testing.assert_array_equal(png.read_png(str(path)), img)
    np.testing.assert_array_equal(imageio.imread(str(path)), img)
    data = bytearray(png.encode_png(img))
    data[8 + 8 + 12] = 1  # IHDR's interlace byte
    data[8 + 8 + 13:8 + 8 + 17] = struct.pack(">I", zlib.crc32(bytes(data[12:8 + 8 + 13])))
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="adam7.png: PNG row 0: unknown filter type"):
        png.read_png(str(path))


@pytest.mark.parametrize("bpp", range(1, 9))
@pytest.mark.parametrize("ftype", range(5))
def test_png_unfilter_in_c_equals_the_python_loop(ftype, bpp):
    """The C row filters against `_unfilter`, the plain version, on random
    bytes: every row of filter type `ftype` but the first two (None, then
    the type again over a row above of zeros and of data)."""
    rng = np.random.RandomState(10 * ftype + bpp)
    h, stride = 6, 7 * bpp + (3 if bpp == 1 else 0)
    raw = rng.randint(0, 256, (h, 1 + stride)).astype(np.uint8)
    raw[:, 0] = ftype
    raw[1, 0] = 0
    for rows in (raw, raw[1:]):
        want = png._unfilter(rows, len(rows), stride, bpp)
        np.testing.assert_array_equal(png.unfilter(rows, len(rows), stride, bpp), want)
    raw[3, 0] = 5
    with pytest.raises(ValueError, match="row 3: unknown filter type 5"):
        png.unfilter(raw, h, stride, bpp)


ADAM7_CASES = {f"ctype{t}_depth{d}": (t, d) for t, depths in ((0, (8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                                                                (4, (8, 16)), (6, (8, 16))) for d in depths}


@pytest.mark.parametrize("case", list(ADAM7_CASES))
def test_adam7_png_equals_imageio(tmp_path, case):
    """Interlaced files of every colour type and bit depth the reader takes,
    at a size where every pass is partial and one of 2x3 where some are
    empty, decode to their samples and to imageio's decode (which keeps 16
    bits only for grey, and reads grey + alpha at 16 bits as RGBA)."""
    ctype, depth = ADAM7_CASES[case]
    rng = np.random.RandomState(depth + 16 * ctype)
    c = png._CHANNELS[ctype]
    top = (1 << depth) - 1 if ctype == 3 else np.iinfo(np.uint16 if depth == 16 else np.uint8).max
    palette = rng.randint(0, 256, (top + 1, 3)) if ctype == 3 else None
    for h, w in ((13, 11), (2, 3)):
        samples = rng.randint(0, top + 1, (h, w, c)).astype(np.uint16 if depth == 16 else np.uint8)
        path = str(tmp_path / f"{case}_{h}x{w}.png")
        with open(path, "wb") as f:
            f.write(adam7_png(samples, depth, ctype, palette))
        want = palette[samples[..., 0]].astype(np.uint8) if ctype == 3 else samples[..., 0] if c == 1 else samples
        got = png.read_png(path)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        ref = imageio.imread(path)
        if depth == 16 and c > 1:
            want = (want >> 8).astype(np.uint8)
            if c == 2:
                want = np.concatenate([want[..., :1].repeat(3, -1), want[..., 1:]], -1)
        np.testing.assert_array_equal(ref, want)


def test_png_paeth_files_on_threads_equal_serial(tmp_path):
    """Four files of Paeth and Average rows decoded on 4 threads (the C
    filters and zlib release the interpreter lock; nothing is shared) equal
    their serial decode and their arrays."""
    rng = np.random.RandomState(11)
    paths, images = [], []
    for i in range(4):
        img = rng.randint(0, 256, (60 + i, 80, 3)).astype(np.uint8)
        path = str(tmp_path / f"{i}.png")
        with open(path, "wb") as f:
            f.write(filtered_png(img, [4, 4, 3, 4]))
        paths.append(path)
        images.append(img)
    serial = [png.read_png(p) for p in paths]
    with ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(png.read_png, paths))
    for a, b, img in zip(serial, threaded, images):
        np.testing.assert_array_equal(a, img)
        np.testing.assert_array_equal(b, img)


def test_png_reader_raises_when_its_library_cannot_be_built(tmp_path, monkeypatch):
    """No quiet fallback to the Python loop: without gcc a read raises."""
    from dogs_tpu_torch.data import native

    path = str(tmp_path / "a.png")
    png.write_png(path, np.zeros((3, 4), np.uint8))

    def no_gcc(source):
        raise FileNotFoundError("gcc")

    monkeypatch.setattr(native, "build", no_gcc)
    png.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"png_codec.c\) could not be built"):
            png.read_png(path)
    finally:
        png.load.cache_clear()


@pytest.mark.parametrize("kind", ["rgb", "grey", "rgba", "grey16", "jpeg"])
def test_load_image_matches_dogs_tpu(tmp_path, kind, monkeypatch):
    """The port decodes with PIL hidden (its PNG reader and its JPEG
    decoder); dogs_tpu through imageio and PIL."""
    rng = np.random.RandomState(7)
    shape = {"rgb": (9, 13, 3), "grey": (9, 13), "rgba": (9, 13, 4), "grey16": (9, 13), "jpeg": (16, 16, 3)}[kind]
    dtype = np.uint16 if kind == "grey16" else np.uint8
    arr = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / ("im.jpg" if kind == "jpeg" else "im.png"))
    imageio.imwrite(path, arr)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        got = tdataset.load_image(path)
    want = jdataset.load_image(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_jpeg_without_pil_decodes_and_progressive_raises(tmp_path, monkeypatch):
    """With PIL hidden a baseline and a progressive JPEG load (the port's
    decoder, equal to PIL's decode here), and a CMYK one, which that decoder
    does not implement, raises naming the file and the process."""
    arr = np.random.RandomState(3).randint(0, 256, (24, 40, 3)).astype(np.uint8)
    photo, prog, cmyk = str(tmp_path / "photo.jpg"), str(tmp_path / "prog.jpg"), str(tmp_path / "cmyk.jpg")
    Image.fromarray(arr).save(photo, quality=90)
    Image.fromarray(arr).save(prog, quality=90, progressive=True)
    Image.fromarray(arr).convert("CMYK").save(cmyk, quality=90)
    want = {p: np.asarray(Image.open(p)).astype(np.float32) / 255.0 for p in (photo, prog)}
    monkeypatch.setitem(sys.modules, "PIL", None)
    for p in (photo, prog):
        np.testing.assert_array_equal(tdataset.load_image(p), want[p])
    with pytest.raises(RuntimeError, match="cmyk.jpg.*CMYK.*PIL"):
        tdataset.load_image(cmyk)


# ---- resizes and caches ----------------------------------------------------------


@pytest.mark.parametrize("size", [(64, 48, 2), (67, 45, 4), (30, 20, 1)])
def test_resize_image_within_one_level_of_pil(size):
    w, h, f = size
    img = np.random.RandomState(w).rand(h, w, 3).astype(np.float32)
    nw, nh = (-(-w // f), -(-h // f)) if f > 1 else (2 * w, 2 * h)
    got, want = tdataset.resize_image(img, nw, nh), jdataset.resize_image(img, nw, nh)
    assert got.shape == want.shape == (nh, nw, 3)
    assert np.abs(got - want).max() <= LEVEL + 1e-7


def test_minify_within_one_level_of_dogs_tpu_pil_cache(tmp_path):
    """Odd sizes (ceil), a subdirectory; both caches decoded by imageio."""
    names = ["sub/a.png", "b.png", "c.jpg"]
    root = write_scene(str(tmp_path / "t" / "scene"), w=67, h=45, image_names=names, n_images=3)
    shutil.copytree(root, str(tmp_path / "j" / "scene"))
    got_dir = tdataset.minify_images(root, 4)
    want_dir = jdataset.minify_images(str(tmp_path / "j" / "scene"), 4)
    for name in names:
        got = tdataset.load_image(os.path.join(got_dir, name))
        want = jdataset.load_image(os.path.join(want_dir, name))
        assert got.shape == want.shape == (12, 17, 3)
        if name.endswith(".png"):  # the reference re-encodes .jpg lossily
            assert np.abs(got - want).max() <= LEVEL + 1e-7, name
        assert png.is_png(os.path.join(got_dir, name))
    assert os.path.basename(got_dir) == "images_4_torch"


def test_minify_caches_of_the_two_packages_stay_apart(tmp_path):
    """In one scene directory the port writes only its own cache and
    dogs_tpu writes its PIL cache beside it, each file in the format its name
    says; the port keeps reading its own, and without one it reads a
    dataset's own images_{factor}/ and writes nothing."""
    names = ["a.png", "b.jpg"]
    root = write_scene(str(tmp_path / "scene"), w=34, h=26, image_names=names, n_images=2)
    got_dir = tdataset.minify_images(root, 2)
    assert sorted(os.listdir(root)) == ["images", "images_2_torch", "sparse"]
    want_dir = jdataset.minify_images(root, 2)
    assert os.path.basename(want_dir) == "images_2"
    for name in names:
        with Image.open(os.path.join(want_dir, name)) as im:
            assert im.format == ("PNG" if name.endswith(".png") else "JPEG")
            assert im.size == (17, 13)
        got = tdataset.load_image(os.path.join(got_dir, name))
        want = tdataset.load_image(os.path.join(want_dir, name))
        if name.endswith(".png"):  # the reference re-encodes .jpg lossily
            assert np.abs(got - want).max() <= LEVEL + 1e-7, name
    assert tdataset.minify_images(root, 2) == got_dir
    shutil.rmtree(got_dir)
    assert tdataset.minify_images(root, 2) == want_dir
    assert sorted(os.listdir(root)) == ["images", "images_2", "sparse"]


def test_undistort_image_equals_dogs_tpu():
    rng = np.random.RandomState(3)
    img = rng.rand(40, 50, 3).astype(np.float32)
    for dist in (np.array([0.1, -0.02, 0.001, 0.002]), np.array([-0.2, 0.05, 0.0, 0.0]), np.zeros(4)):
        got = tdataset.undistort_image(img, 45.0, 44.0, 25.5, 19.0, dist)
        want = jdataset.undistort_image(img, 45.0, 44.0, 25.5, 19.0, dist)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---- load_scene ------------------------------------------------------------------


def assert_scenes_equal(t, j, t_root, j_root):
    for a, b in ((t.train_cameras, j.train_cameras), (t.val_cameras, j.val_cameras)):
        assert len(a) == len(b)
        for rt, rj in zip(a, b):
            np.testing.assert_allclose(rt.R, rj.R, rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(rt.t, rj.t, rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose([rt.fx, rt.fy, rt.cx, rt.cy], [rj.fx, rj.fy, rj.cx, rj.cy], rtol=1e-6)
            assert (rt.width, rt.height, rt.image_index) == (rj.width, rj.height, rj.image_index)
            # The port's caches are dogs_tpu's names with the port's suffix.
            t_rel = os.path.relpath(rt.image_path, t_root).replace(tdataset.CACHE_SUFFIX, "")
            assert t_rel == os.path.relpath(rj.image_path, j_root)
            assert (rt.dist is None) == (rj.dist is None)
            assert rt.load().shape == (rt.height, rt.width, 3)
            cam = rt.to_camera("cpu")
            assert cam.image_index == rt.image_index and cam.width == rt.width
    np.testing.assert_allclose(t.points, j.points, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t.colors, j.colors)
    np.testing.assert_allclose(t.transform, j.transform, rtol=1e-6, atol=1e-12)
    assert t.scale == pytest.approx(j.scale, rel=1e-6)


SCENES = {
    "normalized": (dict(), dict(val_interval=3)),
    "unscaled": (dict(), dict(val_interval=2, normalize=False)),
    "manhattan": (dict(), dict(use_manhattan_world=True, scene_name="campus", normalize=False)),
    "distortion": (dict(model="OPENCV", params=[57.6, 57.0, 32.0, 24.0, 0.05, -0.01, 0.001, 0.0]), dict()),
    "distortion_factor2": (dict(model="OPENCV", params=[57.6, 57.0, 32.0, 24.0, 0.05, -0.01, 0.001, 0.0]),
                           dict(factor=2)),
    "matrix_city": (dict(image_names=["train/a.png", "train/b.png", "test/c.png", "train/d.png"], n_images=4),
                    dict(dataset_name="matrix_city", val_interval=2)),
    "meganerf": (dict(n_images=5), dict(scene_name="rubble")),
    # JPEG images read by both packages at factor 1 (at factor 2 dogs_tpu's
    # minify re-encodes them at PIL's quality 75, the port writes PNG data)
    "jpeg": (dict(image_names=[f"im_{i:03d}.jpg" for i in range(6)]), dict()),
}


@pytest.mark.parametrize("case", list(SCENES))
def test_load_scene_equals_dogs_tpu(tmp_path, case):
    scene_kw, load_kw = SCENES[case]
    t_root = write_scene(str(tmp_path / "t" / "rubble"), **scene_kw)
    j_root = str(tmp_path / "j" / "rubble")
    shutil.copytree(t_root, j_root)
    if case == "manhattan":
        for root in (t_root, j_root):
            shutil.copytree(os.path.join(root, "sparse", "0"), os.path.join(root, "sparse", "manhattan_world"))
    if case == "meganerf":
        for root in (t_root, j_root):
            os.makedirs(os.path.join(root, "val", "rgbs"))
            for name in ("im_001.png", "im_003.png"):
                open(os.path.join(root, "val", "rgbs", name), "w").close()
    t = tdataset.load_scene(t_root, **load_kw)
    j = jdataset.load_scene(j_root, **load_kw)
    assert_scenes_equal(t, j, t_root, j_root)
    if case.startswith("distortion"):  # each package wrote its own undistortion cache
        assert "_undist" in t.train_cameras[0].image_path and t.train_cameras[0].dist is None
        for rt, rj in zip(t.train_cameras, j.train_cameras):
            if case == "distortion":
                np.testing.assert_array_equal(rt.load(), rj.load())
            else:  # undistorted from the two minify caches
                assert np.abs(rt.load() - rj.load()).max() <= LEVEL + 1e-7
    if case == "meganerf":
        assert [os.path.basename(r.image_path) for r in t.val_cameras] == ["im_001.png", "im_003.png"]
    if case == "jpeg":  # the port's decoder against PIL's
        for rt, rj in zip(t.train_cameras + t.val_cameras, j.train_cameras + j.val_cameras):
            assert np.abs(rt.load() - rj.load()).max() <= LEVEL + 1e-7


# ---- the lazy reader -------------------------------------------------------------


def test_lazy_image_list_hinted_and_unhinted_order(tmp_path):
    root = write_scene(str(tmp_path / "scene"), n_images=6, w=16, h=12)
    data = tdataset.load_scene(root, val_interval=0, normalize=False)
    want = [r.load() for r in data.train_cameras]
    images = LazyImageList(data.train_cameras, num_threads=3, lookahead=2)
    try:
        assert len(images) == 6
        for i in (4, 0, 5):  # unhinted
            np.testing.assert_array_equal(images[i], want[i])
        order = [3, 1, 2, 0, 5, 4]
        images.hint(order)
        for i in order:  # hinted, the window sliding along
            np.testing.assert_array_equal(images[i], want[i])
        missing = dataclasses.replace(data.train_cameras[0], image_path=str(tmp_path / "missing.png"))
        broken = LazyImageList([missing], num_threads=1)
        with pytest.raises(FileNotFoundError):
            broken[0]
        broken.close()
    finally:
        images.close()
    assert not any(t.is_alive() for t in images._threads)
