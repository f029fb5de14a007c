"""The benchmark's inputs, made from `--seed`: Gaussian scenes drawn on the
device with a `torch.Generator` in a few large calls, and camera poses.

The scenes follow the port's bench scene generators (dogs_tpu_torch's
bench.py and data/synthetic.py) in their distributions, not their draws:
- `box_scene`: Gaussians filling the frustum of the bench cameras (x in
  [-4, 4], y in [-3, 3], z in [2, 10]) with 2-4 px footprints at f 1000;
- `surface_scene`: the quality teacher, a bumpy ground plane and a sphere
  shell of radius ~1.2 with smooth colours, 2-6 px splats at f 900.
Each stream of draws has a generator of its own, seeded from (seed,
stream), so a scene does not depend on what else a run draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for stream `stream` of run seed `seed` (any integer)."""
    return int(np.random.SeedSequence([seed % 2**64, stream]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def _logit(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


def box_scene(n: int, seed: int, stream: int, device, sh_rest: float) -> dict:
    """n Gaussians of SH degree 3 in the bench cameras' frustum; the 15 rest
    coefficients are normal with deviation `sh_rest`."""
    g = generator(seed, stream, device)
    u = torch.rand((n, 9), generator=g, device=device)
    lo = torch.tensor([-4.0, -3.0, 2.0], device=device)
    xyz = lo + u[:, 0:3] * torch.tensor([8.0, 6.0, 8.0], device=device)
    scale = xyz[:, 2:3] / 1000.0 * (1.5 + 2.5 * u[:, 3:4])
    normal = torch.randn((n, 4 + 45), generator=g, device=device)
    return dict(
        xyz=xyz,
        feat_dc=((u[:, 4:7] - 0.5) / SH_C0)[:, None, :],
        feat_rest=(normal[:, 4:] * sh_rest).reshape(n, 15, 3),
        log_scale=torch.log(scale).repeat(1, 3),
        quat=normal[:, 0:4].contiguous(),
        logit_opacity=_logit(0.3 + 0.6 * u[:, 7:8]),
    )


def surface_scene(n: int, seed: int, stream: int, device) -> dict:
    """The quality teacher: n // 2 splats on the plane y = -1.4 + bumps
    (x, z in [-2.5, 2.5]) and the rest on a sphere shell, SH degree 3 with
    zero rest coefficients."""
    g = generator(seed, stream, device)
    n_pl = n // 2
    n_sp = n - n_pl
    u = torch.rand((n, 7), generator=g, device=device)
    px, pz = -2.5 + 5.0 * u[:n_pl, 0], -2.5 + 5.0 * u[:n_pl, 1]
    py = -1.4 + 0.15 * torch.sin(2.3 * px) * torch.cos(1.7 * pz)
    plane_rgb = torch.stack([0.5 + 0.4 * torch.sin(3.1 * px) * torch.sin(2.2 * pz), 0.5 + 0.35 * torch.cos(2.9 * pz),
                             0.45 + 0.3 * torch.sin(1.3 * px + 2.1 * pz)], -1)
    normal = torch.randn((n, 7), generator=g, device=device)
    d = normal[:n_sp, 0:3]
    d = d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-9)
    sphere = d * (1.2 + 0.05 * torch.sin(5.0 * d[:, :1]) * torch.cos(4.0 * d[:, 1:2]))
    rgb = torch.clamp(torch.cat([plane_rgb, 0.5 + 0.45 * d]), 0.02, 0.98)
    s_lo = 0.008 * math.sqrt(200_000 / n)
    return dict(
        xyz=torch.cat([torch.stack([px, py, pz], -1), sphere]),
        feat_dc=((rgb - 0.5) / SH_C0)[:, None, :],
        feat_rest=torch.zeros((n, 15, 3), device=device),
        log_scale=torch.log(s_lo * (1.0 + 2.1 * u[:, 2:5])),
        quat=normal[:, 3:7].contiguous(),
        logit_opacity=_logit(0.55 + 0.4 * u[:, 5:6]),
    )


def bench_poses(n: int, width: int, height: int) -> list[dict]:
    """The port's bench cameras: at the origin, yawed and pitched by a few
    degrees each, f 1000 at 1152 px wide (scaled with the width)."""
    f = 1000.0 * width / 1152
    poses = []
    for i in range(n):
        a, b = (i - n / 2) * 0.02, ((i * 7) % n - n / 2) * 0.012
        poses.append(dict(R=_ry(a) @ _rx(b), t=np.zeros(3), fx=f, fy=f, cx=width / 2, cy=height / 2,
                          width=width, height=height))
    return poses


def viewer_poses(n: int, seed: int, stream: int, width: int, height: int, focal: float, yaw_deg: float,
                 pitch_deg: float, xy: float, z_range: tuple) -> list[dict]:
    """n poses of a viewer around the bench cameras' origin: yaw and pitch
    uniform within +-yaw_deg and +-pitch_deg, the centre moved by up to +-xy
    in x and y and by z in z_range (into the volume)."""
    rng = np.random.RandomState(stream_seed(seed, stream) % 2**32)
    u = rng.uniform(-1.0, 1.0, (n, 5))
    poses = []
    for yaw, pitch, x, y, z in u:
        R = _ry(math.radians(yaw_deg) * yaw) @ _rx(math.radians(pitch_deg) * pitch)
        c = np.array([xy * x, xy * y, z_range[0] + (z + 1) / 2 * (z_range[1] - z_range[0])])
        poses.append(dict(R=R, t=-R @ c, fx=focal, fy=focal, cx=width / 2, cy=height / 2, width=width,
                          height=height))
    return poses


def ring_poses(n: int, radius: float, width: int, height: int, focal: float, elevation: float = -0.8) -> list[dict]:
    """n cameras on a ring of `radius` at height `elevation`, looking at the
    origin, y down."""
    poses = []
    for i in range(n):
        th = 2 * math.pi * i / n
        eye = np.array([radius * math.cos(th), elevation, radius * math.sin(th)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, -1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1).T
        poses.append(dict(R=R, t=-R @ eye, fx=focal, fy=focal, cx=width / 2, cy=height / 2, width=width,
                          height=height))
    return poses


def _ry(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rx(b: float) -> np.ndarray:
    c, s = math.cos(b), math.sin(b)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def view(pose: dict, device, dtype=torch.float32):
    """The pose as the reference's camera (float32 once from float64)."""
    from benchmark.reference.raster import View

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float64).astype(np.float32), device=device).to(dtype)

    return View(f32(pose["R"]), f32(pose["t"]), *(float(np.float32(pose[k])) for k in ("fx", "fy", "cx", "cy")),
                pose["width"], pose["height"])
