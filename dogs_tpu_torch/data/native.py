"""ctypes bindings of the native COLMAP parser (`csrc/colmap_fast.c`), and
the build of the port's C libraries.

Port of dogs_tpu/data/native.py with its own copy of the C source. A
library builds at first use with `gcc -O3 -shared -fPIC` into
`dogs_tpu_torch/_build/`, under a name that carries a hash of the source
and the flags (`build`; utils/jpeg.py builds the image codec with it);
`load()` returns None where it cannot build or load (no gcc), and the
readers of data/colmap.py then take their numpy path. A file that ends
inside a record raises `ValueError` here (dogs_tpu's binding returns None
and its Python fallback raises).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "colmap_fast.c"
BUILD_DIR = _PKG / "_build"
GCC_FLAGS = ("-O3", "-shared", "-fPIC")

_c_long, _ptr = ctypes.c_long, ctypes.c_void_p


def build(source: Path) -> ctypes.CDLL:
    """Load the shared library of the C file `source`, compiling it first
    when `_build/` has none for this source and these flags. Raises OSError
    or subprocess.CalledProcessError when gcc is missing or fails."""
    digest = hashlib.sha256(" ".join(GCC_FLAGS).encode() + source.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"{source.stem}_{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["gcc", *GCC_FLAGS, "-o", tmp, str(source)], check=True, capture_output=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL | None:
    """The parser's library, built once per source hash; None if gcc is
    missing or the build or load fails (logged)."""
    try:
        lib = build(SOURCE)
    except (OSError, subprocess.CalledProcessError) as e:
        logger.info("native COLMAP parser unavailable (%s); the numpy readers run", e)
        return None
    lib.parse_points3d.argtypes = [_ptr, _c_long, _c_long, _ptr, _ptr, _ptr]
    lib.parse_points3d.restype = _c_long
    lib.parse_images.argtypes = [_ptr, _c_long, _c_long, _ptr, _ptr, _ptr, _ptr, ctypes.c_char_p, _c_long]
    lib.parse_images.restype = _c_long
    return lib


def _read(path: str, min_record: int) -> tuple[np.ndarray, int]:
    """The file's bytes and its record count, checked against the bytes
    that `min_record`-byte records would need."""
    data = np.fromfile(path, np.uint8)
    if data.size < 8:
        raise ValueError(f"{path}: {data.size} bytes, shorter than its record count")
    n = int(data[:8].view("<u8")[0])
    if n > (data.size - 8) // min_record:
        raise ValueError(f"{path}: {n} records cannot fit in {data.size} bytes")
    return data, n


def read_points3d_bin(lib: ctypes.CDLL, path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xyz float64 (P, 3), rgb uint8 (P, 3), error float64 (P,)) of a
    points3D.bin, parsed by the native library."""
    data, n = _read(path, 51)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    got = lib.parse_points3d(data.ctypes.data, data.size, n, xyz.ctypes.data, rgb.ctypes.data, err.ctypes.data)
    if got != n:
        raise ValueError(f"{path}: malformed or truncated points3D.bin ({got} of {n} points parsed)")
    return xyz, rgb, err


def read_images_bin(lib: ctypes.CDLL, path: str) -> list[tuple[int, np.ndarray, np.ndarray, int, str]]:
    """[(image_id, qvec (4,), tvec (3,), camera_id, name)] of an images.bin
    in file order, parsed by the native library."""
    data, n = _read(path, 65)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam_id = np.empty((n,), np.int32)
    img_id = np.empty((n,), np.int32)
    names = ctypes.create_string_buffer(data.size)
    got = lib.parse_images(data.ctypes.data, data.size, n, qvec.ctypes.data, tvec.ctypes.data, cam_id.ctypes.data,
                           img_id.ctypes.data, names, data.size)
    if got != n:
        raise ValueError(f"{path}: malformed or truncated images.bin ({got} of {n} images parsed)")
    name_list = names.raw.split(b"\x00")[:n]
    return [(int(img_id[i]), qvec[i].copy(), tvec[i].copy(), int(cam_id[i]), name_list[i].decode("utf-8"))
            for i in range(n)]
