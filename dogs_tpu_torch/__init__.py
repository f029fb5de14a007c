"""PyTorch + CUDA port of dogs_tpu for NVIDIA Hopper (H100).

Mirrors the layout of `dogs_tpu/` (core, fields, raster, eval, train, data,
utils) so each module sits at the path of its JAX counterpart. This package
imports torch and numpy only: never jax, never PyYAML at module level, and
never a `dogs_tpu` module or file; what it needs of dogs_tpu's JAX-free
modules it keeps as its own copies (train/schedule.py, utils/config.py).
Hand-written CUDA kernels live under `csrc/` and build at first use into
`_build/` (kernels.py).
"""
