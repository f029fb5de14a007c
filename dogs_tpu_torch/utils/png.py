"""PNG files without PIL or imageio: a writer and a reader.

The port writes its renders, trajectory frames and image caches with this
and reads PNG scenes with it, so that neither needs imageio or PIL. The
writer writes 8- or 16-bit grey, grey + alpha, RGB or RGBA with filter type
0 on every row (zlib + struct). The reader decodes bit depths 8 and 16 of
colour types 0, 2, 4 and 6, palettes (colour type 3) at 1, 2, 4 and 8 bits,
plain and interlaced (Adam7, by its seven passes) files: zlib inflates, and
the row filters (all five types) are undone in C (`csrc/png_codec.c`, built
with gcc at first use by `data/native.py:build`, bound with ctypes). Both
release the interpreter lock, so the lazy reader's threads decode in
parallel. Without gcc the library cannot be built and a read raises.
`_unfilter` is the same work in Python and numpy, the plain version the
tests hold the C one against.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

from dogs_tpu_torch.data import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "png_codec.c"
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (3: one palette index)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples per pixel -> colour type written
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """An (H, W) or (H, W, C) uint8 or uint16 array, C in 1..4 (grey, grey +
    alpha, RGB, RGBA), as the bytes of a PNG file with that colour type and
    bit depth, every row with filter type 0, compressed at zlib `level`."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype not in (np.uint8, np.uint16) or img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"expected an (H, W[, 1-4]) uint8 or uint16 array, got {img.dtype} {img.shape}")
    h, w, c = img.shape
    depth = 8 * img.dtype.itemsize
    samples = img.astype(">u2") if depth == 16 else img
    rows = np.zeros((h, 1 + w * c * img.dtype.itemsize), np.uint8)  # a leading 0: no filter
    rows[:, 1:] = samples.reshape(h, -1).view(np.uint8)
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOUR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write an array (see `encode_png`) to `path` as a PNG."""
    data = encode_png(img, level)
    with open(path, "wb") as f:
        f.write(data)


def png_size(path: str) -> tuple[int, int]:
    """(width, height) from a PNG file's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">II", head[16:24])


def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of `raw` ((h, 1 + stride) bytes, filter type
    first) into (h, stride) bytes. `bpp`: bytes per complete pixel (at
    least 1), the distance to the byte on the left."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    for y in range(h):
        ftype, line = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum mod 256 over each byte lane
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros((pad,), np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the decoded byte on its left
            cur = bytearray(stride)
            up = prev.tolist()
            for i, v in enumerate(line.tolist()):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    cur[i] = (v + ((left + up[i]) >> 1)) & 0xFF
                else:
                    cur[i] = (v + _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The row-filter library, built once per source hash. Raises
    RuntimeError when it cannot be built or loaded (no gcc)."""
    try:
        lib = native.build(SOURCE)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = e.stderr.decode(errors="replace") if isinstance(e, subprocess.CalledProcessError) else e
        raise RuntimeError(f"the PNG codec ({SOURCE.name}) could not be built or loaded: {detail}") from e
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_void_p]
    lib.png_unfilter.restype = ctypes.c_long
    return lib


def unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """`_unfilter`'s result, computed in C: the (h, stride) bytes of the
    filtered rows `raw` ((h, 1 + stride) uint8). Raises ValueError at a row
    of unknown filter type."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.shape != (h, 1 + stride) or not 1 <= bpp <= 8:
        raise ValueError(f"expected ({h}, {1 + stride}) filtered bytes at 1-8 bytes a pixel, got {raw.shape}, {bpp}")
    out = np.empty((h, stride), np.uint8)
    bad = load().png_unfilter(raw.ctypes.data, h, stride, bpp, out.ctypes.data)
    if bad >= 0:
        raise ValueError(f"PNG row {bad}: unknown filter type {int(raw[bad, 0])}")
    return out


def _pixels(data: np.ndarray, h: int, w: int, c: int, depth: int) -> tuple[np.ndarray, int]:
    """Unfilter one image (or Adam7 pass) of h x w pixels from the front of
    `data`: its (h, w, c) samples and the bytes it took."""
    stride = -(-w * c * depth // 8)  # bytes a row
    size = h * (1 + stride)
    if data.size < size:
        raise ValueError(f"{data.size} bytes of image data, expected {size}")
    pixels = unfilter(data[:size].reshape(h, 1 + stride), h, stride, max(c * depth // 8, 1))
    if depth == 16:
        return pixels.view(">u2").astype(np.uint16).reshape(h, w, c), size
    if depth < 8:  # packed palette indices, the first pixel in the high bits
        img = np.unpackbits(pixels, axis=1).reshape(h, -1, depth)[:, :w]
        return (img * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)[..., None], size
    return pixels.reshape(h, w, c), size


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file as imageio does: uint8 or uint16 (the file's bit
    depth), (H, W) grey, (H, W, 2) grey + alpha, (H, W, 3) RGB, (H, W, 4)
    RGBA; a palette expands to RGB (a tRNS chunk's alpha is dropped, as
    imageio drops it). Interlaced files decode by Adam7's seven passes."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in ((1, 2, 4, 8) if ctype == 3 else (8, 16)):
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} is not supported")
    if interlace > 1:
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    try:
        if not interlace:
            img, used = _pixels(raw, h, w, c, depth)
        else:
            img, used = np.empty((h, w, c), np.uint16 if depth == 16 else np.uint8), 0
            for x0, y0, dx, dy in ADAM7:
                pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
                if pw > 0 and ph > 0:  # an empty pass has no bytes, not even filter types
                    img[y0::dy, x0::dx], size = _pixels(raw[used:], ph, pw, c, depth)
                    used += size
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if used != raw.size:
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {used}")
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        return palette[img[..., 0]]
    return img[..., 0] if c == 1 else img
