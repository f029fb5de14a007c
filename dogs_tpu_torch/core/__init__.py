from dogs_tpu_torch.core.camera import Camera, look_at_camera, make_camera
from dogs_tpu_torch.core.gaussians import (
    GaussianParams,
    empty_params,
    inverse_sigmoid,
    pad_to_capacity,
    params_from_numpy,
    round_up_capacity,
)
from dogs_tpu_torch.core.knn import mean_knn_dist_sq
from dogs_tpu_torch.core.sh import eval_sh, num_sh_bases, rgb_to_sh, sh_to_rgb
from dogs_tpu_torch.core.transforms import (
    build_covariance_3d,
    covariance_sym6,
    normalize,
    quat_multiply,
    quat_rotate,
    quat_to_rotmat,
    rotmat_to_quat,
)
