"""JPEG files without PIL: a decoder and an encoder in C
(`csrc/jpeg_codec.c`), bound with ctypes.

The decoder reads Huffman-coded JPEG, sequential (SOF0, and SOF1 at 8 bits)
and progressive (SOF2: spectral selection and successive approximation,
end-of-band runs), with 1 or 3 components, every integral chroma
subsampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...), restart intervals and
several tables, and returns what `np.asarray(PIL.Image.open(path))`
returns, bit for bit: uint8 (H, W, 3) or (H, W), decoded as libjpeg decodes
by default (the ISLOW IDCT, fancy upsampling, fixed-point YCbCr -> RGB),
with no EXIF rotation. A process it does not implement (lossless,
hierarchical, arithmetic coding, 12-bit samples, 4-component CMYK / YCCK)
raises `UnsupportedJpeg`, and so does a progressive file whose scans leave
bits of coefficients 1-9 unsent, which libjpeg would smooth; a truncated or
corrupt stream raises `ValueError`; both name the file. No partial image is
returned.

The encoder writes baseline JFIF files (libjpeg's quality scaling of the
Annex K tables, the Annex K Huffman tables, 4:4:4, 4:2:2, 4:2:0 or 4:4:0,
an optional restart interval), or progressive ones of the same quantized
coefficients (libjpeg's `jpeg_simple_progression` script, Huffman tables
optimized per scan), so that a JPEG dataset can be written where PIL is
missing.

The library builds with gcc at first use (`data/native.py:build`) and holds
no global state: ctypes releases the interpreter lock during each call, so
the lazy reader's threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path

import numpy as np

from dogs_tpu_torch.data import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_codec.c"
SIGNATURE = b"\xff\xd8\xff"  # SOI and the first byte of the next marker
SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:4:0": (1, 2)}  # luma h x v against chroma 1x1
_OK, _UNSUPPORTED = 0, 1
_ERRLEN = 256

_int, _long, _ptr = ctypes.c_int, ctypes.c_long, ctypes.c_void_p


class UnsupportedJpeg(ValueError):
    """A valid JPEG file whose coding process the decoder does not implement."""


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The codec's library, built once per source hash. Raises RuntimeError
    when it cannot be built or loaded (no gcc)."""
    try:
        lib = native.build(SOURCE)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = e.stderr.decode(errors="replace") if isinstance(e, subprocess.CalledProcessError) else e
        raise RuntimeError(f"the JPEG codec ({SOURCE.name}) could not be built or loaded: {detail}") from e
    lib.jpeg_header.argtypes = [ctypes.c_char_p, _long, ctypes.POINTER(_int), ctypes.POINTER(_int),
                                ctypes.POINTER(_int), ctypes.c_char_p, _int]
    lib.jpeg_header.restype = _int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, _long, _ptr, _int, _int, _int, ctypes.c_char_p, _int]
    lib.jpeg_decode.restype = _int
    lib.jpeg_encode.argtypes = [_ptr, _int, _int, _int, _int, _int, _int, _int, _int, ctypes.POINTER(_long)]
    lib.jpeg_encode.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.jpeg_free.argtypes = [_ptr]
    lib.jpeg_free.restype = None
    lib.gif_lzw.argtypes = [_ptr, _long, _ptr, _long]
    lib.gif_lzw.restype = _long
    return lib


def is_jpeg(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(3) == SIGNATURE


def _raise(code: int, err: ctypes.Array, name: str) -> None:
    msg = f"{name}: {err.value.decode(errors='replace')}"
    raise UnsupportedJpeg(msg) if code == _UNSUPPORTED else ValueError(msg)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The pixels of a JPEG file's bytes: uint8 (H, W, 3) or (H, W).
    `name` goes into the error messages."""
    lib = load()
    err = ctypes.create_string_buffer(_ERRLEN)
    w, h, c = _int(), _int(), _int()
    code = lib.jpeg_header(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), err, _ERRLEN)
    if code != _OK:
        _raise(code, err, name)
    out = np.empty((h.value, w.value, c.value), np.uint8)
    code = lib.jpeg_decode(data, len(data), out.ctypes.data, w.value, h.value, c.value, err, _ERRLEN)
    if code != _OK:
        _raise(code, err, name)
    return out[..., 0] if c.value == 1 else out


def read_jpeg(path: str) -> np.ndarray:
    """Decode a JPEG file (see `decode_jpeg`); errors name the file."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, path)


def encode_jpeg(img: np.ndarray, quality: int = 95, subsampling: str = "4:2:0", restart_interval: int = 0,
                progressive: bool = False) -> bytes:
    """A JFIF file of an (H, W) grey or (H, W, 3) RGB uint8 array at libjpeg
    `quality` (1-100), chroma `subsampling` (a key of SUBSAMPLING; ignored
    for grey) and a restart marker every `restart_interval` MCUs (0: none),
    baseline or `progressive` (libjpeg's simple progression, 10 scans for
    RGB and 6 for grey, tables optimized per scan). The progressive file
    decodes to the baseline file's pixels."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (1, 3))):
        raise ValueError(f"expected an (H, W) or (H, W, 3) uint8 array, got {img.dtype} {img.shape}")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"subsampling {subsampling!r}: expected one of {sorted(SUBSAMPLING)}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    hs, vs = SUBSAMPLING[subsampling]
    size = _long()
    lib = load()
    buf = lib.jpeg_encode(img.ctypes.data, w, h, c, int(quality), hs, vs, int(restart_interval), int(progressive),
                          ctypes.byref(size))
    if not buf:
        raise ValueError(f"cannot encode a {w}x{h}x{c} image (at most 65535 a side, restart interval 0-65535)")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.jpeg_free(buf)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95, subsampling: str = "4:2:0",
               restart_interval: int = 0, progressive: bool = False) -> None:
    """Write an array as a JPEG file (see `encode_jpeg`)."""
    data = encode_jpeg(img, quality, subsampling, restart_interval, progressive)
    with open(path, "wb") as f:
        f.write(data)
