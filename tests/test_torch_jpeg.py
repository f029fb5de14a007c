"""The port's JPEG codec (dogs_tpu_torch/utils/jpeg.py over
csrc/jpeg_codec.c) against PIL, which decodes with libjpeg(-turbo), and its
GIF writer (utils/gif.py) against imageio. Images are seeded numpy arrays
(smooth ramps plus noise at odd sizes); PIL writes the JPEG files the
decoder reads.

The decoder's bar is one 8-bit level of `np.asarray(Image.open(f))` for a
baseline file and none (bit for bit) for a progressive one; each case
prints the share of samples that are exactly equal (run with -s).
"""

import io
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from dogs_tpu_torch.utils import gif, jpeg, png

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_jpeg"


def source_image(h: int, w: int, seed: int, grey: bool = False) -> np.ndarray:
    """Ramps in three directions plus Gaussian noise of 20 levels, uint8."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ramps = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1), (x + y) * 128 / (w + h)], -1)
    img = np.clip(ramps + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    return float(10 * np.log10(255.0**2 / np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))


def assert_within_one_level(got: np.ndarray, want: np.ndarray, label: str, levels: int = 1) -> None:
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.dtype, got.shape, want.shape)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{label}: {float((diff == 0).mean()):.6f} of samples exactly equal, max |d| {int(diff.max())}")
    assert int(diff.max()) <= levels, label


# ---- the decoder against PIL ------------------------------------------------------

SIZES = [(37, 53), (65, 33)]
DECODE_CASES = {
    **{f"{h}x{w}_q{q}_sub{s}": ((h, w), dict(quality=q, subsampling=s))
       for h, w in SIZES for q in (50, 75, 95, 100) for s in (0, 1, 2)},
    **{f"{h}x{w}_grey_q{q}": ((h, w), dict(quality=q, grey=True)) for h, w in SIZES for q in (75, 95)},
    **{f"{h}x{w}_optimize_sub{s}": ((h, w), dict(quality=90, subsampling=s, optimize=True))
       for h, w in SIZES[:1] for s in (0, 2)},
    "37x53_grey_optimize": ((37, 53), dict(quality=85, grey=True, optimize=True)),
    **{f"{h}x{w}_restart_blocks": ((h, w), dict(quality=90, subsampling=2, restart_marker_blocks=3)) for h, w in SIZES},
    **{f"{h}x{w}_restart_rows": ((h, w), dict(quality=90, subsampling=1, restart_marker_rows=1)) for h, w in SIZES},
    "1x1": ((1, 1), dict(quality=90, subsampling=2)),
    "3x2_sub1": ((3, 2), dict(quality=90, subsampling=1)),
    # progressive (libjpeg's simple progression: spectral selection, successive
    # approximation, end-of-band runs): bit for bit
    **{f"{h}x{w}_progressive_q{q}_sub{s}": ((h, w), dict(quality=q, subsampling=s, progressive=True))
       for h, w in SIZES for q in (75, 95) for s in (0, 1, 2)},
    **{f"{h}x{w}_progressive_grey": ((h, w), dict(quality=90, grey=True, progressive=True)) for h, w in SIZES},
    "37x53_progressive_restart_blocks": ((37, 53), dict(quality=90, subsampling=2, progressive=True,
                                                        restart_marker_blocks=3)),
    "65x33_progressive_restart_rows": ((65, 33), dict(quality=90, subsampling=1, progressive=True,
                                                      restart_marker_rows=1)),
    "1x1_progressive": ((1, 1), dict(quality=90, subsampling=2, progressive=True)),
    "240x320_progressive_q50_sub2": ((240, 320), dict(quality=50, subsampling=2, progressive=True)),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decoder_within_one_level_of_pil(case):
    (h, w), kw = DECODE_CASES[case]
    kw = dict(kw)
    img = source_image(h, w, seed=h * w + kw["quality"], grey=kw.pop("grey", False))
    data = pil_jpeg(img, **kw)
    assert_within_one_level(jpeg.decode_jpeg(data, case), pil_decode(data), case, 0 if kw.get("progressive") else 1)


@pytest.mark.parametrize("size", SIZES)
def test_decoder_reads_4_4_0_within_one_level_of_pil(size):
    """PIL writes no 4:4:0 (h1v2) file, so the port's encoder writes it and
    PIL decodes it for the reference."""
    data = jpeg.encode_jpeg(source_image(*size, seed=5), 90, "4:4:0", restart_interval=2)
    assert_within_one_level(jpeg.decode_jpeg(data), pil_decode(data), f"{size} 4:4:0")


def progressive(img):
    return pil_jpeg(img, quality=90, progressive=True)


def cmyk(img):
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def truncated(img, keep=0.5):
    data = pil_jpeg(img, quality=90)
    return data[:int(len(data) * keep)]


def unrefined(img):
    """A progressive file cut after its sixth scan and closed with EOI: the
    last bit of every AC coefficient stays unsent, so libjpeg would smooth
    its blocks."""
    data = progressive(img)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    dht = data.find(b"\xff\xc4", sos[5], sos[6])  # the next scan's tables, where it has any
    return data[:dht if dht > 0 else sos[6]] + b"\xff\xd9"


REJECTIONS = {
    "truncated_progressive": (lambda img: progressive(img)[:len(progressive(img)) // 2], ValueError, "truncated"),
    "unrefined_progressive": (unrefined, jpeg.UnsupportedJpeg, "unsent.*smooths"),
    "cmyk": (cmyk, jpeg.UnsupportedJpeg, "CMYK"),
    "truncated_half": (truncated, ValueError, "truncated"),
    "truncated_in_header": (lambda img: pil_jpeg(img, quality=90)[:200], ValueError, "truncated"),
    "not_a_jpeg": (lambda img: png.encode_png(img), ValueError, "not a JPEG"),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_decoder_rejects_naming_the_file(tmp_path, case):
    make, error, words = REJECTIONS[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(make(source_image(40, 56, seed=1)))
    with pytest.raises(error, match=f"{case}.jpg.*{words}") as info:
        jpeg.read_jpeg(str(path))
    assert isinstance(info.value, jpeg.UnsupportedJpeg) == (error is jpeg.UnsupportedJpeg)


def test_decoder_on_threads_equals_serial(tmp_path):
    """16 files decoded on 8 threads (ctypes releases the interpreter lock
    and the library keeps no global state) equal their serial decode."""
    paths = []
    for i in range(16):
        path = str(tmp_path / f"{i:02d}.jpg")
        with open(path, "wb") as f:
            f.write(pil_jpeg(source_image(96 + i, 128 - i, seed=i), quality=70 + i, subsampling=i % 3))
        paths.append(path)
    serial = [jpeg.read_jpeg(p) for p in paths]
    with ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(jpeg.read_jpeg, paths))
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a, b)


# ---- the encoder -----------------------------------------------------------------------

ENCODE_CASES = {
    **{f"{name}_q{q}": (name, q) for name in ("4:4:4", "4:2:2", "4:2:0") for q in (75, 95)},
    "grey_q90": ("grey", 90),
}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encoder_file_reads_in_pil_and_matches_pil_quality(tmp_path, case):
    """PIL decodes write_jpeg's file within one level of the port's decoder,
    and its PSNR against the source is within 0.5 dB of PIL's own encode at
    the same quality and subsampling."""
    name, quality = ENCODE_CASES[case]
    grey = name == "grey"
    img = source_image(65, 91, seed=quality, grey=grey)
    path = str(tmp_path / "x.jpg")
    subsampling = "4:2:0" if grey else name
    jpeg.write_jpeg(path, img, quality=quality, subsampling=subsampling, restart_interval=0 if quality == 75 else 4)
    with Image.open(path) as im:
        assert im.format == "JPEG" and im.mode == ("L" if grey else "RGB")
        pil = np.asarray(im)
    mine = jpeg.read_jpeg(path)
    assert_within_one_level(mine, pil, case)
    ref = pil_jpeg(img, quality=quality, **({} if grey else {"subsampling": subsampling}))
    assert abs(psnr(mine, img) - psnr(pil_decode(ref), img)) <= 0.5


PROGRESSIVE_CASES = {
    **{f"{name}_q{q}": ((53, 91), name, q, 0) for name in ("4:4:4", "4:2:2", "4:2:0", "4:4:0") for q in (75, 95)},
    "grey_q90": ((53, 91), "grey", 90, 0),
    "4:2:2_restart_rows": ((65, 91), "4:2:2", 90, 6),
    "4:2:0_restart_3": ((65, 91), "4:2:0", 85, 3),
    "grey_restart_5": ((37, 29), "grey", 80, 5),
    "1x1": ((1, 1), "4:2:0", 90, 0),
}


@pytest.mark.parametrize("case", list(PROGRESSIVE_CASES))
def test_progressive_encoder_decodes_to_its_baseline_twin(case):
    """encode_jpeg(progressive=True) writes libjpeg's simple progression (10
    scans for RGB, 6 for grey, a DHT before every scan that codes with a
    table) over the baseline file's quantized coefficients: PIL and the
    port's decoder each decode the two files to the same pixels, and PIL
    reads the file as progressive."""
    (h, w), name, quality, restart = PROGRESSIVE_CASES[case]
    grey = name == "grey"
    img = source_image(h, w, seed=quality + restart, grey=grey)
    sub = "4:2:0" if grey else name
    base = jpeg.encode_jpeg(img, quality, sub, restart)
    prog = jpeg.encode_jpeg(img, quality, sub, restart, progressive=True)
    assert prog.count(b"\xff\xc2") == 1 and b"\xff\xc0" not in prog
    assert prog.count(b"\xff\xda") == (6 if grey else 10)
    with Image.open(io.BytesIO(prog)) as im:
        assert im.info.get("progressive") == 1 and im.mode == ("L" if grey else "RGB")
    np.testing.assert_array_equal(pil_decode(prog), pil_decode(base))
    np.testing.assert_array_equal(jpeg.decode_jpeg(prog), jpeg.decode_jpeg(base))
    assert_within_one_level(jpeg.decode_jpeg(prog), pil_decode(prog), case, 0)


def test_encoder_rejects_bad_input():
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="subsampling"):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.uint8), subsampling="4:1:1")


# ---- the committed fixture ---------------------------------------------------------------

# name -> PIL's save arguments; each file is PIL's JPEG of one source image,
# and <name>.png is PIL's decode of it, written by the port's PNG writer.
FIXTURE_CASES = {
    "sub420": dict(quality=90, subsampling=2),
    "sub422_restart": dict(quality=85, subsampling=1, restart_marker_blocks=2),
    "sub444": dict(quality=95, subsampling=0),
    "grey": dict(quality=90),
    "optimized": dict(quality=80, subsampling=2, optimize=True),
    "progressive": dict(quality=80, progressive=True),
}
FIXTURE_SIZE = (37, 53)


def write_fixture(out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for i, (name, kw) in enumerate(FIXTURE_CASES.items()):
        data = pil_jpeg(source_image(*FIXTURE_SIZE, seed=100 + i, grey=name == "grey"), **kw)
        (out / f"{name}.jpg").write_bytes(data)
        png.write_png(str(out / f"{name}.png"), pil_decode(data))


def test_fixture_matches_pil_and_the_decoder(tmp_path):
    """The committed files are what PIL writes and decodes here (so the
    fixture cannot go stale), under 50 KB in all, and the port's decoder
    reads each within one level of its PNG, the progressive file bit for bit
    (the card machine, which has no PIL, checks the same in
    chip_smoke.py)."""
    write_fixture(tmp_path)
    names = sorted(os.listdir(FIXTURE))
    assert names == sorted(os.listdir(tmp_path))
    assert sum(os.path.getsize(FIXTURE / n) for n in names) < 50_000
    for name in names:
        committed = (FIXTURE / name).read_bytes()
        if name.endswith(".png"):
            np.testing.assert_array_equal(png.read_png(str(FIXTURE / name)), png.read_png(str(tmp_path / name)))
        else:
            assert committed == (tmp_path / name).read_bytes(), name
    for name in FIXTURE_CASES:
        got = jpeg.read_jpeg(str(FIXTURE / f"{name}.jpg"))
        assert_within_one_level(got, png.read_png(str(FIXTURE / f"{name}.png")), name, 0 if name == "progressive" else 1)


# ---- the scene writer's JPEG format ------------------------------------------------------------


def test_colmap_scene_writes_jpeg_images_the_loader_reads(tmp_path, monkeypatch):
    """tools/colmap_scene.py with fmt="jpeg": images/*.JPG, 4:2:0 at quality
    95 for the first JPEG_420_IMAGES and 4:2:2 with restart markers after,
    read by load_scene through the port's decoder with PIL hidden, within
    one level of PIL's decode."""
    from PIL import JpegImagePlugin

    from dogs_tpu_torch.data import dataset, synthetic
    from dogs_tpu_torch.tools import colmap_scene

    monkeypatch.setattr(colmap_scene, "JPEG_420_IMAGES", 2)
    cams = colmap_scene.make_cameras(4, 40, 30, 35.0, device="cpu")
    colmap_scene.write_scene(str(tmp_path / "scene"), synthetic.bench_scene(300, device="cpu"), cams,
                             fmt="jpeg", upsample=3)
    names = sorted(os.listdir(tmp_path / "scene" / "images"))
    assert names == [f"frame_{i:03d}.JPG" for i in range(4)]
    for i, name in enumerate(names):
        path = str(tmp_path / "scene" / "images" / name)
        data = Path(path).read_bytes()
        with Image.open(path) as im:
            assert im.size == (120, 90) and JpegImagePlugin.get_sampling(im) == (2 if i < 2 else 1)
        assert (b"\xff\xdd" in data) == (i >= 2)  # DRI
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "PIL", None)
            got = dataset.decode_image(path)
        assert_within_one_level(got, pil_decode(data), name)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        scene = dataset.load_scene(str(tmp_path / "scene"), factor=3, val_interval=2, normalize=False)
    assert [r.load().shape for r in scene.train_cameras] == [(30, 40, 3)] * 2
    assert sorted(os.listdir(tmp_path / "scene")) == ["images", "images_3_torch", "images_3_torch_undist_torch",
                                                      "sparse"]


def test_colmap_scene_writes_progressive_jpegs_equal_to_its_baseline_scene(tmp_path, monkeypatch):
    """fmt="jpeg-progressive" writes the same views with the same settings as
    progressive files: each decodes, in PIL and in the port's decoder, to the
    pixels of the baseline scene's file, and load_scene reads them with PIL
    hidden."""
    from dogs_tpu_torch.data import dataset, synthetic
    from dogs_tpu_torch.tools import colmap_scene

    monkeypatch.setattr(colmap_scene, "JPEG_420_IMAGES", 1)
    cams = colmap_scene.make_cameras(3, 40, 30, 35.0, device="cpu")
    params = synthetic.bench_scene(300, device="cpu")
    for fmt in ("jpeg", "jpeg-progressive"):
        colmap_scene.write_scene(str(tmp_path / fmt), params, cams, fmt=fmt, upsample=2)
    for i in range(3):
        name = f"frame_{i:03d}.JPG"
        base = (tmp_path / "jpeg" / "images" / name).read_bytes()
        prog = (tmp_path / "jpeg-progressive" / "images" / name).read_bytes()
        assert b"\xff\xc2" in prog and (b"\xff\xdd" in prog) == (i >= 1)
        np.testing.assert_array_equal(pil_decode(prog), pil_decode(base))
        np.testing.assert_array_equal(jpeg.decode_jpeg(prog, name), pil_decode(base))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        scene = dataset.load_scene(str(tmp_path / "jpeg-progressive"), factor=2, val_interval=2, normalize=False)
    assert [r.load().shape for r in scene.train_cameras] == [(30, 40, 3)]


# ---- the GIF writer -----------------------------------------------------------------------


def gif_frames(n, h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return [np.clip(np.stack([128 + 100 * np.sin(x / 17 + i), 128 + 100 * np.cos(y / 23 - i), x * y / (w * h) * 255],
                             -1) + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8) for i in range(n)]


def gif_info(path):
    with Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append((im.info["duration"], im.info["loop"]))
    return out


@pytest.mark.parametrize("fps", [15, 30])
def test_gif_reads_back_as_imageio_writes_it(tmp_path, fps):
    """write_gif against imageio.mimwrite on the same frames: imageio reads
    both back with the same frame count, shapes, per-frame duration and
    loop 0, and the port's GIF is at most 1 dB further from the frames."""
    frames = gif_frames(4, 50, 70, seed=fps)
    mine, ref = str(tmp_path / "mine.gif"), str(tmp_path / "ref.gif")
    gif.write_gif(mine, frames, duration=1000.0 / fps, loop=0)
    imageio.mimwrite(ref, frames, duration=1000.0 / fps, loop=0)
    got, want = imageio.mimread(mine), imageio.mimread(ref)
    assert len(got) == len(want) == len(frames)
    assert [g.shape for g in got] == [w.shape for w in want] == [(50, 70, 3)] * 4
    assert gif_info(mine) == gif_info(ref) == [(int(100 / fps) * 10, 0)] * 4
    for g, w, f in zip(got, want, frames):
        assert psnr(g, f) >= psnr(w, f) - 1.0, (psnr(g, f), psnr(w, f))


def test_gif_lzw_holds_a_full_code_table(tmp_path):
    """A frame of noise over all 256 indices fills the 4096-entry LZW table
    many times (clear codes, 12-bit codes); PIL decodes the indices back
    exactly."""
    rng = np.random.RandomState(0)
    frame = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    palette, indices = gif.median_cut(frame)
    path = str(tmp_path / "noise.gif")
    gif.write_gif(path, [frame], duration=100)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), indices)
        np.testing.assert_array_equal(np.asarray(im.getpalette(), np.uint8).reshape(-1, 3)[:256], palette)
