"""The numbers that decide `correct`, each a gap between the program and
the plain reference (lower is better; a cell's limit caps each).

Training (the program's first steps against the reference's):
  loss_gap    the largest |loss_p - loss_r| / |loss_r| over the steps;
  grad_gap    the worst leaf's |norm_p - norm_r| of the first step's
              gradient as the optimizer takes it, over the larger of that
              leaf's reference norm and the median leaf's;
  change_gap  the same for the parameters' change over the steps, over the
              leaves whose reference gradient is at least 1e-3 of the
              median leaf's (a leaf under that moves by round-off alone).
Frames: rms_gap, the largest root-mean-square difference of a frame from
the reference's render of the same pose, over the sampled requests.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3  # of the median leaf's reference gradient norm


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items() if v.numel()}


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    keys = [k for k in ref if leaves is None or k in leaves]
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def moving_leaves(ref_grad_norms: dict) -> list:
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= NEGLIGIBLE * med]


def training_readings(prog: dict, ref: dict) -> dict:
    """`prog` and `ref` hold losses (list), grad (leaf -> norm) and change
    (leaf -> norm)."""
    return dict(loss_gap=loss_gap(prog["losses"], ref["losses"]),
                grad_gap=worst_leaf_gap(prog["grad"], ref["grad"]),
                change_gap=worst_leaf_gap(prog["change"], ref["change"], moving_leaves(ref["grad"])))


def rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.double() - b.double()) ** 2).mean().sqrt())
