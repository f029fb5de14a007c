"""Per-Gaussian preprocess of `render_tiled` on the card: one hand-written
kernel that writes the blend's (N, 16) entry matrix and the radii straight
from the raw leaves, and one that writes the leaves' gradients from the
entry matrix's cotangent.

The forward computes what `project_gaussians` followed by `entry_matrix`
computes (raster/projection.py), in the same order of operations; the
backward is the vector-Jacobian product of that map, recomputed from the
leaves and the saved radii, with autograd's rules at every clamp and
`where`. Both kernels are csrc/preprocess.cu (arithmetic in
csrc/preprocess.cuh); they replace no TPU kernel, since dogs_tpu leaves this
chain to XLA's fusion. `_Preprocess` binds them as one autograd node;
`preprocess` is what `render_tiled` calls on CUDA tensors with
`cfg.use_kernel`. Elsewhere `render_tiled` keeps `project_gaussians` +
`entry_matrix` and their autograd.

Contract (`Inputs`): the leaves xyz (N, 3), log_scale (N, 3), quat (N, 4),
logit_opacity (N, 1), feat_dc (N, 1, 3), feat_rest (N, R, 3), optional
color_override (N, 3) (then the SH leaves are not read), means2d_offset
(N, 2) and invd_offset (N,), all f32; the camera (R and t may carry
gradients: pose refinement; fx, fy, cx, cy may not); alive (N,) bool or
None; the SH degree (0-4, at most the stored one), antialiasing and the
scale modifier.
  forward  -> ent (N, 16) in blend.ENT_* columns, radius (N,) (0 = culled)
  backward <- d_ent (N, 16), zero on culled rows (no tile reads them);
              -> each input's gradient where asked for: the depth column
              carries none, a culled slot gets zeros, the offsets get
              d_ent's own columns on every slot.

`preprocess_forward` / `preprocess_backward` launch the kernels (CUDA
tensors only) through `kernels.launch`; the `*_reference` functions compute
the same from `project_gaussians` + `entry_matrix` and autograd, on any
device. The kernels build at first use (dogs_tpu_torch/kernels.py).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from dogs_tpu_torch import kernels
from dogs_tpu_torch.core.camera import Camera
from dogs_tpu_torch.core.gaussians import GaussianParams, NeuralGaussians
from dogs_tpu_torch.raster import blend
from dogs_tpu_torch.raster.projection import entry_matrix, project_gaussians
from dogs_tpu_torch.utils import trace

SLOTS = ("xyz", "log_scale", "quat", "logit_opacity", "feat_dc", "feat_rest", "color_override",
         "means2d_offset", "invd_offset")
GRAD_NAMES = SLOTS + ("R", "t")  # the inputs that can carry gradients, in `_Preprocess`'s order
MAX_SH_DEGREE = 4
CAM_GRADS = 12  # d R row-major, then d t
THREADS = 128  # slots a block (csrc/preprocess.cu)

_VP = ctypes.c_void_p


class KernelArgs(ctypes.Structure):
    """csrc/preprocess.cuh's `Args`, field for field."""

    _fields_ = [(name, _VP) for name in (
        "xyz", "log_scale", "quat", "logit_opacity", "feat_dc", "feat_rest", "color", "means2d_offset",
        "invd_offset", "alive", "R", "t", "fx", "fy", "cx", "cy",
    )] + [(name, ctypes.c_int) for name in ("n", "rest_rows", "width", "height", "degree", "antialiasing")] + [
        ("scale_modifier", ctypes.c_float)
    ]


class KernelGrads(ctypes.Structure):
    """csrc/preprocess.cuh's `Grads`, field for field."""

    _fields_ = [(name, _VP) for name in (
        "d_ent", "radius", "xyz", "log_scale", "quat", "logit_opacity", "feat_dc", "feat_rest", "color",
        "means2d_offset", "invd_offset", "camera",
    )]


_FWD_ARGTYPES = (ctypes.POINTER(KernelArgs), _VP, _VP, _VP)
_BWD_ARGTYPES = (ctypes.POINTER(KernelArgs), ctypes.POINTER(KernelGrads), _VP, _VP)


@dataclasses.dataclass(frozen=True)
class Inputs:
    """One call's inputs (module docstring)."""

    xyz: torch.Tensor
    log_scale: torch.Tensor
    quat: torch.Tensor
    logit_opacity: torch.Tensor
    feat_dc: torch.Tensor
    feat_rest: torch.Tensor
    color_override: torch.Tensor | None
    means2d_offset: torch.Tensor | None
    invd_offset: torch.Tensor | None
    camera: Camera
    alive: torch.Tensor | None = None
    degree: int = 3
    antialiasing: bool = False
    scale_modifier: float = 1.0

    def tensor(self, name: str) -> torch.Tensor | None:
        """The input `name` of GRAD_NAMES."""
        return getattr(self.camera, name) if name in ("R", "t") else getattr(self, name)

    def with_tensors(self, tensors: dict) -> "Inputs":
        """A copy with the GRAD_NAMES inputs in `tensors` replaced."""
        cam = {k: tensors[k] for k in ("R", "t") if k in tensors}
        slots = {k: v for k, v in tensors.items() if k in SLOTS}
        return dataclasses.replace(self, camera=dataclasses.replace(self.camera, **cam), **slots)


def check_inputs(x: Inputs) -> None:
    """Raise on what the kernels do not take."""
    n = x.xyz.shape[0]
    override = x.color_override is not None
    shapes = {"xyz": (n, 3), "log_scale": (n, 3), "quat": (n, 4), "logit_opacity": (n, 1), "feat_dc": (n, 1, 3),
              "color_override": (n, 3), "means2d_offset": (n, 2), "invd_offset": (n,), "R": (3, 3), "t": (3,)}
    for name in GRAD_NAMES:
        t = x.tensor(name)
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"preprocess: {name} must be float32, got {t.dtype}")
        want = shapes.get(name)
        if want is not None and tuple(t.shape) != want:
            raise ValueError(f"preprocess: {name} must be {want}, got {tuple(t.shape)}")
    if x.feat_rest.dim() != 3 or x.feat_rest.shape[0] != n or x.feat_rest.shape[2] != 3:
        raise ValueError(f"preprocess: feat_rest must be ({n}, R, 3), got {tuple(x.feat_rest.shape)}")
    if not 0 <= x.degree <= MAX_SH_DEGREE:
        raise ValueError(f"SH degree must be in [0, {MAX_SH_DEGREE}], got {x.degree}")
    if not override and (x.degree + 1) ** 2 - 1 > x.feat_rest.shape[1]:
        raise ValueError(f"SH degree {x.degree} needs {(x.degree + 1) ** 2 - 1} rest rows, "
                         f"the leaves hold {x.feat_rest.shape[1]}")
    if x.alive is not None and (x.alive.dtype != torch.bool or tuple(x.alive.shape) != (n,)):
        raise ValueError(f"preprocess: alive must be ({n},) bool, got {tuple(x.alive.shape)} {x.alive.dtype}")
    if n >= 2**31 // blend.ENT_WIDTH:
        raise ValueError(f"preprocess: {n} slots exceed the kernels' int32 counts")


def contiguous(x: Inputs) -> Inputs:
    """`x` with every tensor contiguous, the intrinsics as f32 tensors on the
    leaves' device (a no-op for the trainers' own inputs)."""
    dev = x.xyz.device
    cam = x.camera
    intr = {k: torch.as_tensor(getattr(cam, k), dtype=torch.float32, device=dev).contiguous()
            for k in ("R", "t", "fx", "fy", "cx", "cy")}
    slots = {k: None if getattr(x, k) is None else getattr(x, k).contiguous() for k in SLOTS}
    alive = None if x.alive is None else x.alive.contiguous()
    return dataclasses.replace(x, camera=dataclasses.replace(cam, **intr), alive=alive, **slots)


def kernel_args(x: Inputs) -> KernelArgs:
    """The C struct of a contiguous `x` (pointers into its tensors, which
    must outlive the launch's enqueue)."""

    def ptr(t):
        return None if t is None else t.data_ptr()

    cam = x.camera
    return KernelArgs(
        *(ptr(getattr(x, k)) for k in SLOTS), ptr(x.alive),
        *(ptr(getattr(cam, k)) for k in ("R", "t", "fx", "fy", "cx", "cy")),
        x.xyz.shape[0], x.feat_rest.shape[1], cam.width, cam.height, x.degree, int(x.antialiasing),
        float(x.scale_modifier),
    )


def preprocess_forward(x: Inputs) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream (no sync): the entry
    matrix (N, 16) and the radii (N,). CUDA tensors only: a CPU tensor
    raises (`preprocess_forward_reference` is the plain version)."""
    check_inputs(x)
    x = contiguous(x)
    cam = x.camera
    present = [t for t in (*(getattr(x, k) for k in SLOTS), x.alive, cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy)
               if t is not None]
    kernels.require_cuda("preprocess_forward", *present)
    n = x.xyz.shape[0]
    ent = torch.empty((n, blend.ENT_WIDTH), dtype=torch.float32, device=x.xyz.device)
    radius = torch.empty((n,), dtype=torch.float32, device=x.xyz.device)
    args = kernel_args(x)
    kernels.launch("preprocess", "dogs_preprocess_forward", _FWD_ARGTYPES, ctypes.byref(args), ent.data_ptr(),
                   radius.data_ptr(), device=x.xyz.device)
    return ent, radius


def preprocess_backward(x: Inputs, d_ent: torch.Tensor, radius: torch.Tensor, needs) -> tuple:
    """Launch the backward kernel on the current stream (no sync). `needs`
    gives, in GRAD_NAMES order, which gradients to write; returns them in
    that order, None where not asked for (and for the SH leaves under a
    colour override, which the forward did not read). With R or t asked
    for, a second kernel sums the camera's per-block partials in a fixed
    order."""
    check_inputs(x)
    x = contiguous(x)
    n = x.xyz.shape[0]
    d_ent = d_ent.contiguous()
    if d_ent.dtype != torch.float32 or tuple(d_ent.shape) != (n, blend.ENT_WIDTH):
        raise ValueError(f"d_ent must be ({n}, {blend.ENT_WIDTH}) float32, got {tuple(d_ent.shape)} {d_ent.dtype}")
    kernels.require_cuda("preprocess_backward", x.xyz, d_ent, radius)
    want = dict(zip(GRAD_NAMES, needs))
    if x.color_override is not None:
        want["feat_dc"] = want["feat_rest"] = False
    else:
        want["color_override"] = False
    out = {k: torch.empty_like(x.tensor(k)) if want[k] and x.tensor(k) is not None else None for k in SLOTS}
    cam_out = partials = None
    if want["R"] or want["t"]:
        cam_out = torch.empty((CAM_GRADS,), dtype=torch.float32, device=x.xyz.device)
        partials = torch.empty((-(-n // THREADS), CAM_GRADS), dtype=torch.float32, device=x.xyz.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    grads = KernelGrads(d_ent.data_ptr(), radius.data_ptr(), *(ptr(out[k]) for k in SLOTS), ptr(cam_out))
    args = kernel_args(x)
    kernels.launch("preprocess", "dogs_preprocess_backward", _BWD_ARGTYPES, ctypes.byref(args),
                   ctypes.byref(grads), ptr(partials), device=x.xyz.device)
    d_r = cam_out[:9].view(3, 3) if cam_out is not None and want["R"] else None
    d_t = cam_out[9:] if cam_out is not None and want["t"] else None
    return (*(out[k] for k in SLOTS), d_r, d_t)


def preprocess_forward_reference(x: Inputs) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, on any device:
    `project_gaussians` then `entry_matrix`."""
    check_inputs(x)
    gauss = NeuralGaussians(xyz=x.xyz, feat_dc=x.feat_dc, feat_rest=x.feat_rest, log_scale=x.log_scale,
                            quat=x.quat, logit_opacity=x.logit_opacity)
    proj = project_gaussians(gauss, x.camera, alive=x.alive, active_sh_degree=x.degree,
                             antialiasing=x.antialiasing, scale_modifier=x.scale_modifier,
                             means2d_offset=x.means2d_offset, color_override=x.color_override)
    return entry_matrix(proj, x.invd_offset), proj.radius


def preprocess_backward_reference(x: Inputs, d_ent: torch.Tensor, radius: torch.Tensor, needs) -> tuple:
    """Plain version of the backward kernel, on any device: autograd through
    `preprocess_forward_reference`, the gradients asked for in GRAD_NAMES
    order (None where not asked for or not reached). `radius` is unused:
    the plain forward recomputes it."""
    del radius
    leaves = {k: x.tensor(k).detach().requires_grad_(bool(need))
              for k, need in zip(GRAD_NAMES, needs) if x.tensor(k) is not None}
    wanted = [k for k, need in zip(GRAD_NAMES, needs) if need and k in leaves]
    got = {}
    if wanted:
        with torch.enable_grad():
            ent, _ = preprocess_forward_reference(x.with_tensors(leaves))
            grads = torch.autograd.grad(ent, [leaves[k] for k in wanted], d_ent, allow_unused=True)
        got = dict(zip(wanted, grads))
    return tuple(got.get(k) for k in GRAD_NAMES)


class _Preprocess(torch.autograd.Function):
    """The kernel pair as one autograd node. Inputs: `options` (an `Inputs`
    whose GRAD_NAMES tensors are ignored), then the GRAD_NAMES tensors
    (None where absent). Outputs: the entry matrix and the radii (no
    gradient). CUDA tensors only, as the kernels. Saved for the backward:
    the inputs as given and the radii, nothing the forward computed
    besides."""

    @staticmethod
    def forward(ctx, options, *tensors):
        x = options.with_tensors(dict(zip(GRAD_NAMES, tensors)))
        ent, radius = preprocess_forward(x)
        ctx.mark_non_differentiable(radius)
        ctx.save_for_backward(*tensors, radius)
        ctx.options = options
        return ent, radius

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_ent, _d_radius):
        *tensors, radius = ctx.saved_tensors
        x = ctx.options.with_tensors(dict(zip(GRAD_NAMES, tensors)))
        with trace.span("dogs.raster.project_bwd"):
            grads = preprocess_backward(x, d_ent, radius, ctx.needs_input_grad[1:])
        return (None, *grads)


def preprocess(
    params: GaussianParams | NeuralGaussians,
    camera: Camera,
    alive: torch.Tensor | None = None,
    active_sh_degree: int = 3,
    antialiasing: bool = False,
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    invd_offset: torch.Tensor | None = None,
    color_override: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The entry matrix (N, 16) and radii (N,) of `render_tiled`'s
    arguments through `_Preprocess` (CUDA tensors only): differentiable in
    the six leaves, the two offsets, the colour override and the camera's R
    and t."""
    if torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in (camera.fx, camera.fy, camera.cx, camera.cy)
    ):
        raise ValueError("preprocess: the intrinsics carry no gradient; only the camera's R and t may")
    options = Inputs(None, None, None, None, None, None, None, None, None, camera, alive, active_sh_degree,
                     antialiasing, scale_modifier)
    tensors = (params.xyz, params.log_scale, params.quat, params.logit_opacity, params.feat_dc, params.feat_rest,
               color_override, means2d_offset, invd_offset, camera.R, camera.t)
    return _Preprocess.apply(options, *tensors)
