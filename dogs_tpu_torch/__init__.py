"""PyTorch + CUDA port of dogs_tpu for NVIDIA Hopper (H100).

Mirrors the layout of `dogs_tpu/` (core, fields, raster, eval, train, data)
so each module sits at the path of its JAX counterpart. This package imports
torch and numpy only: never jax, and never a `dogs_tpu` module (the JAX-free
dogs_tpu/train/schedule.py is shared by loading its file, see
train/trainer.py). Hand-written CUDA kernels live under `csrc/` and build at
first use into `_build/` (kernels.py).
"""
