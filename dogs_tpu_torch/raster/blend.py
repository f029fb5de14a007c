"""Tile alpha-blend forward: the Hopper kernel and its plain PyTorch version.

Port of dogs_tpu/raster/pallas_stream.py:blend_forward_stream (and of the
per-tile pallas_blend.py:blend_forward_pallas, same contract). The kernel
(csrc/blend_forward.cu) runs one 256-thread CTA per 16x16 tile; its header
says what it computes and what bounds it. `blend_forward_reference` computes
the same thing the way the XLA path of dogs_tpu/raster/tiled.py does (tile
batches, chunked log-space cumsum, batch early exit), vectorized in torch.

Contract shared by both:
  ent     (K, 16) f32 entry matrix in sorted order (ENT_* columns)
  starts  (n_tiles + 1,) int32 tile ranges into `ent`
  returns (n_tiles, 5, 256) f32: rows R, G, B, A, invD per pixel of each
          tile, no background; empty tiles and pixels past width/height are 0.

`blend_forward` launches the kernel and accepts CUDA tensors only;
`render_tiled` takes the plain version for CPU tensors. The kernel builds at
first use with nvcc from the repo's source into `dogs_tpu_torch/_build/`,
cached by a hash of the source.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import subprocess
import tempfile
from pathlib import Path

import torch

# Entry-matrix columns (row-major (K, ENT_WIDTH)); the kernel reads 0-9.
ENT_MUX, ENT_MUY, ENT_CA, ENT_CB, ENT_CC, ENT_R, ENT_G, ENT_B, ENT_OPA, ENT_INVD, ENT_DEPTH = range(11)
ENT_WIDTH = 16
OUT_ROWS = 5  # R, G, B, A, invD
TILE = 16  # the kernel's tile edge: one thread per pixel of a 16x16 tile
LOG_TMIN = math.log(1e-4)
ALPHA_MIN = 1.0 / 255.0
# Plain blend schedule: tiles per batch and entries per step. Each step holds
# a few (batch, chunk, 256) f32 arrays, ~8 MB each.
_REF_TILE_BATCH, _REF_CHUNK = 256, 32

_PKG = Path(__file__).resolve().parents[1]
KERNEL_SOURCE = _PKG / "csrc" / "blend_forward.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


@functools.lru_cache(maxsize=1)
def build_kernel() -> tuple[ctypes.CDLL, str]:
    """Compile (once per source hash) and load the kernel library.

    Returns (library, nvcc's output, which holds the -Xptxas -v report).
    Raises if nvcc is missing or the build fails."""
    from torch.utils.cpp_extension import CUDA_HOME

    src = KERNEL_SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"blend_forward_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if not lib_path.exists():
        nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
        if CUDA_HOME is None or not nvcc.exists():
            raise RuntimeError(f"no CUDA toolkit with nvcc found: cannot build {KERNEL_SOURCE}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            [str(nvcc), *NVCC_FLAGS, "-o", tmp, str(KERNEL_SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {KERNEL_SOURCE}:\n{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.dogs_blend_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, log_path.read_text() if log_path.exists() else ""


def _check_inputs(ent: torch.Tensor, starts: torch.Tensor, n_tiles: int) -> None:
    if ent.dtype != torch.float32 or ent.dim() != 2 or ent.shape[1] != ENT_WIDTH:
        raise ValueError(f"ent must be (K, {ENT_WIDTH}) float32, got {tuple(ent.shape)} {ent.dtype}")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (n_tiles + 1,):
        raise ValueError(
            f"starts must be ({n_tiles + 1},) int32, got {tuple(starts.shape)} {starts.dtype}"
        )
    if not (ent.is_contiguous() and starts.is_contiguous()):
        raise ValueError("ent and starts must be contiguous")


def blend_forward(
    ent: torch.Tensor,
    starts: torch.Tensor,
    n_tiles_y: int,
    n_tiles_x: int,
    width: int,
    height: int,
) -> torch.Tensor:
    """Launch the Hopper blend kernel on the current stream (no sync).

    CUDA tensors only: a CPU tensor raises, since the kernel has no CPU
    build (use `blend_forward_reference` there). `starts` must be
    nondecreasing with starts[-1] <= K, as build_tile_bins makes it; that is
    not checked here, since reading it back would synchronize."""
    n_tiles = n_tiles_y * n_tiles_x
    if not (ent.is_cuda and starts.is_cuda and ent.device == starts.device):
        raise ValueError(
            f"blend_forward runs the CUDA kernel: ent on {ent.device} and starts on "
            f"{starts.device} must share one CUDA device"
        )
    _check_inputs(ent, starts, n_tiles)
    lib, _ = build_kernel()
    out = torch.empty((n_tiles, OUT_ROWS, TILE * TILE), dtype=torch.float32, device=ent.device)
    with torch.cuda.device(ent.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dogs_blend_forward(
            ent.data_ptr(), starts.data_ptr(), out.data_ptr(),
            n_tiles_x, n_tiles, width, height, stream,
        )
    if err != 0:
        raise RuntimeError(f"blend_forward kernel launch failed: CUDA error {err}")
    blend_forward.launches += 1
    return out


blend_forward.launches = 0  # kernel launches since the last reset


def blend_forward_reference(
    ent: torch.Tensor,
    starts: torch.Tensor,
    n_tiles_y: int,
    n_tiles_x: int,
    width: int,
    height: int,
    tile_size: int = TILE,
) -> torch.Tensor:
    """Plain PyTorch blend with the kernel's contract, on any device.

    Tiles go in batches of _REF_TILE_BATCH; each batch walks its entries
    _REF_CHUNK at a time with the inclusive log-transmittance from a cumsum,
    and stops once every pixel of the batch is saturated."""
    n_tiles = n_tiles_y * n_tiles_x
    _check_inputs(ent, starts, n_tiles)
    device = ent.device
    ts = tile_size
    tile_batch, chunk = _REF_TILE_BATCH, _REF_CHUNK
    p = ts * ts
    k_total = ent.shape[0]
    out = torch.zeros((n_tiles, OUT_ROWS, p), dtype=torch.float32, device=device)
    if k_total == 0:
        return out
    lane = torch.arange(p, device=device)
    ar_chunk = torch.arange(chunk, device=device)
    starts64 = starts.to(torch.int64)
    for b0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(b0, min(b0 + tile_batch, n_tiles), device=device)
        s0 = starts64[tiles]
        s1 = starts64[tiles + 1]
        max_cnt = int((s1 - s0).max())
        if max_cnt == 0:
            continue
        ix = (tiles % n_tiles_x)[:, None] * ts + lane % ts  # (TB, P)
        iy = (tiles // n_tiles_x)[:, None] * ts + lane // ts
        px = ix.to(torch.float32) + 0.5
        py = iy.to(torch.float32) + 0.5
        # Pixels past the image edge start saturated: they never blend.
        log_t = torch.where(
            (ix < width) & (iy < height),
            torch.zeros((), device=device),
            torch.full((), -math.inf, device=device),
        )
        acc = torch.zeros((tiles.shape[0], OUT_ROWS, p), dtype=torch.float32, device=device)
        for off in range(0, max_cnt, chunk):
            if float(log_t.max()) < LOG_TMIN:
                break  # every pixel of the batch is done
            pos = s0[:, None] + off + ar_chunk  # (TB, CH)
            valid = pos < s1[:, None]
            rows = ent[torch.clamp(pos, max=k_total - 1)]  # (TB, CH, 16)
            dx = px[:, None, :] - rows[:, :, ENT_MUX, None]
            dy = py[:, None, :] - rows[:, :, ENT_MUY, None]
            power = (
                -0.5 * (rows[:, :, ENT_CA, None] * dx * dx + rows[:, :, ENT_CC, None] * dy * dy)
                - rows[:, :, ENT_CB, None] * dx * dy
            )
            alpha = torch.clamp(
                rows[:, :, ENT_OPA, None] * torch.exp(torch.clamp(power, max=0.0)), max=0.99
            )
            alpha = torch.where((alpha >= ALPHA_MIN) & valid[:, :, None], alpha, 0.0)
            lg = torch.log1p(-alpha)
            cum = torch.cumsum(lg, dim=1)
            log_t_incl = log_t[:, None, :] + cum
            w = torch.where(log_t_incl >= LOG_TMIN, alpha * torch.exp(log_t_incl - lg), 0.0)
            cols = rows[:, :, [ENT_R, ENT_G, ENT_B, ENT_INVD]]  # (TB, CH, 4)
            # Elementwise products summed over the chunk: exact f32, no TF32.
            acc[:, [0, 1, 2, 4]] += (w[:, :, None, :] * cols[:, :, :, None]).sum(dim=1)
            acc[:, 3] += w.sum(dim=1)
            log_t = log_t + cum[:, -1, :]
        out[tiles] = acc
    return out
