from dogs_tpu_torch.core.camera import Camera, look_at_camera, make_camera
from dogs_tpu_torch.core.gaussians import (
    GaussianParams,
    empty_params,
    inverse_sigmoid,
    params_from_numpy,
)
from dogs_tpu_torch.core.sh import eval_sh, num_sh_bases, rgb_to_sh, sh_to_rgb
from dogs_tpu_torch.core.transforms import covariance_sym6, normalize, quat_to_rotmat
