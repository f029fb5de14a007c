"""Animated GIF files without imageio: `write_gif`.

Each frame gets its own 256-colour palette by median cut (numpy: boxes of a
5-bit-per-channel colour histogram split at the weighted median of their
widest-spread channel, the box with the largest squared error first; each
palette entry is the mean colour of its box's pixels, and each histogram
cell maps to its nearest entry). The indices are LZW-coded by the C codec
library (`csrc/jpeg_codec.c:gif_lzw`). The file is what
`imageio.mimwrite(path, frames, duration=ms, loop=loop)` writes through
Pillow: GIF89a, a NETSCAPE2.0 loop count, each frame's delay
`int(duration / 10)` centiseconds.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

from dogs_tpu_torch.utils import jpeg

BITS = 5  # histogram bits per channel
COLORS = 256


def median_cut(frame: np.ndarray, colors: int = COLORS) -> tuple[np.ndarray, np.ndarray]:
    """(palette (colors, 3) uint8, indices (H, W) uint8) of an (H, W, 3)
    uint8 frame; unused palette entries are black."""
    pix = frame.reshape(-1, 3)
    q = pix >> (8 - BITS)
    cell = (q[:, 0].astype(np.int32) << (2 * BITS)) | (q[:, 1].astype(np.int32) << BITS) | q[:, 2]
    n_cells = 1 << (3 * BITS)
    count = np.bincount(cell, minlength=n_cells)
    used = np.flatnonzero(count)
    w = count[used].astype(np.float64)
    mean = np.stack([np.bincount(cell, weights=pix[:, k], minlength=n_cells)[used] for k in range(3)], 1) / w[:, None]

    def sse(m, wt):  # the box's weighted squared error about its mean; 0 for one cell (rounding aside)
        if wt.size < 2:
            return 0.0
        s1 = wt @ m
        return max(float(wt @ (m * m).sum(1) - s1 @ s1 / wt.sum()), 0.0)

    boxes = [(mean, w)]
    errors = [sse(mean, w)]
    while len(boxes) < colors:
        b = int(np.argmax(errors))
        if errors[b] <= 0.0:
            break
        m, wt = boxes[b]
        order = np.argsort(m[:, int(np.argmax(m.max(0) - m.min(0)))], kind="stable")
        m, wt = m[order], wt[order]
        cum = np.cumsum(wt)
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2.0), 0, wt.size - 2)) + 1
        boxes[b:b + 1] = [(m[:cut], wt[:cut]), (m[cut:], wt[cut:])]
        errors[b:b + 1] = [sse(m[:cut], wt[:cut]), sse(m[cut:], wt[cut:])]
    pal = np.clip(np.rint(np.stack([wt @ m / wt.sum() for m, wt in boxes])), 0, 255)
    dist = (pal * pal).sum(1)[None, :] - 2.0 * mean @ pal.T  # |mean - entry|^2 less |mean|^2
    lut = np.zeros(n_cells, np.uint8)
    lut[used] = np.argmin(dist, 1)
    palette = np.zeros((colors, 3), np.uint8)
    palette[:len(boxes)] = pal
    return palette, lut[cell].reshape(frame.shape[:2])


def _lzw(indices: np.ndarray) -> bytes:
    """GIF image data (minimum code size, sub-blocks, terminator) of uint8
    palette indices."""
    lib = jpeg.load()
    flat = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    cap = 2 * flat.size + 1024  # 12-bit codes and the sub-block lengths
    out = np.empty(cap, np.uint8)
    n = lib.gif_lzw(flat.ctypes.data, flat.size, out.ctypes.data, cap)
    if n <= 0:
        raise RuntimeError(f"GIF LZW coding failed ({n})")
    return out[:n].tobytes()


def write_gif(path: str, frames: Sequence[np.ndarray], duration: float = 100.0, loop: int = 0) -> None:
    """Write (H, W, 3) uint8 frames of one size as an animated GIF, each
    shown `duration` milliseconds, repeated `loop` times (0: forever)."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"expected (H, W, 3) uint8 frames of one size, got {f.dtype} {f.shape}")
    delay = int(duration / 10)
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),  # no global palette, 8-bit colour resolution
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for f in frames:
        palette, indices = median_cut(f)
        parts.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")  # graphic control: the delay
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87))  # a local palette of 256 entries
        parts.append(palette.tobytes())
        parts.append(_lzw(indices))
    parts.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
