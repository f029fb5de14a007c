"""Operations and bytes that a step's or a frame's inputs need, for the
roofline shares and the step's share of the chip's peak.

Peaks: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's data sheet: 67
TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM. A kernel's
least time is the larger of its operations over the first and its bytes
over the second, each input byte read once and each output byte written
once. The pair counts come from the reference's blend (`raster.blend`
counts, over the step's own tile lists, the (pixel, entry) pairs each
pixel visits up to and including its stop, and those that contribute).
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Flops per (pixel, entry) pair of the blends: every visited pair (dx, dy,
# the quadratic form, min, exp, x opacity, min, the 1/255 test) and on top
# per contributing pair (forward: log1p, the log T add and test, exp, w,
# four FMAs, A += w; backward: the direct term, the prefix, d_alpha with its
# division, d_power, the ten gradients and their ten sums).
FLOPS_VISITED = 16
FLOPS_CONTRIB = {"forward": 15, "backward": 55}
ROW_FLOATS = 11  # an entry row as the blends read it: mean 2, conic 3, rgb 3, opacity, inverse depth, depth
OUT_ROWS = 5  # forward: rgb, alpha, inverse depth per pixel
COT_ROWS = 6  # backward: the pixel's rgb, alpha and depth cotangents and its total
GRAD_COLS = 10  # backward: an entry's gradient
PIXELS_PER_TILE = 256

# Flops of one drawn Gaussian's projection, counted from
# reference/raster.py:project: camera transform 18, pixel 6, rotation from
# the quaternion 48, R S 12, the 3-D covariance 30, the Jacobian 16, J W 18,
# the 2-D covariance 60, conic 9, radius 10, opacity 4.
PROJECTION_FLOPS = 231
# The view direction (12) and the SH colour at each degree: the basis
# products and 3 channels x 2 flops a coefficient, plus the shift and clamp.
SH_FLOPS = {0: 14, 1: 44, 2: 88, 3: 140}
# Per pixel, forward: L1 9; SSIM's 5 separable blurs of 3 channels (11 + 11
# taps, 2 flops a tap) 660, the products 9 and the SSIM map 60.
LOSS_FLOPS_PER_PIXEL = 738
# A backward costs twice its forward (the usual count for a VJP).
BACKWARD_FACTOR = 2
# Sparse Adam per parameter of a drawn Gaussian: the two moments 7, sqrt,
# add, divide, scale, subtract.
ADAM_FLOPS = 12
GAUSSIAN_PARAMS = 59  # xyz 3, SH 48, scale 3, quaternion 4, opacity 1


def blend_bound(kind: str, visited: int, contributing: int, rows: int, entries: int, n_tiles: int) -> float:
    """Least seconds of one blend `kind` ("forward" or "backward") over
    `entries` (Gaussian, tile) entries of `rows` distinct Gaussians."""
    flops = FLOPS_VISITED * visited + FLOPS_CONTRIB[kind] * contributing
    read = 4 * (rows * ROW_FLOATS + entries + n_tiles + 1)
    if kind == "forward":
        moved = read + 4 * n_tiles * OUT_ROWS * PIXELS_PER_TILE
    else:
        moved = read + 4 * (n_tiles * COT_ROWS * PIXELS_PER_TILE + entries * GRAD_COLS)
    return max(flops / PEAK_F32_FLOPS, moved / PEAK_BYTES_PER_S)


def step_flops(drawn: int, sh_degree: int, visited: int, contributing: int, pixels: int) -> float:
    """Flops of one 3DGS training step: projection and SH forward and
    backward of the drawn Gaussians, both blends, the loss forward and
    backward, and Adam on the drawn Gaussians."""
    per_gaussian = (PROJECTION_FLOPS + SH_FLOPS[sh_degree]) * (1 + BACKWARD_FACTOR) + ADAM_FLOPS * GAUSSIAN_PARAMS
    blends = 2 * FLOPS_VISITED * visited + (FLOPS_CONTRIB["forward"] + FLOPS_CONTRIB["backward"]) * contributing
    return drawn * per_gaussian + blends + pixels * LOSS_FLOPS_PER_PIXEL * (1 + BACKWARD_FACTOR)


def frame_flops(drawn: int, sh_degree: int, visited: int, contributing: int) -> float:
    """Flops of one served frame: projection and SH forward of the drawn
    Gaussians and the forward blend."""
    return drawn * (PROJECTION_FLOPS + SH_FLOPS[sh_degree]) + FLOPS_VISITED * visited + \
        FLOPS_CONTRIB["forward"] * contributing
