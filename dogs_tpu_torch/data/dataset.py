"""Scene dataset: COLMAP loading, pose normalization, splits, image caches.

Port of dogs_tpu/data/dataset.py: a host-side loader that yields camera
records (numpy poses and intrinsics, `to_camera()` builds the port's
Camera) and numpy images.
  * COLMAP model parsing (data/colmap.py),
  * similarity normalization from the cameras: world-up alignment,
    centering, and a scale that fits the cameras in a unit ball,
  * the optional manhattan-world axis swap,
  * the minification cache and the undistortion cache, generated on first
    use,
  * the val split: every val_interval-th image, the Mega-NeRF val lists, or
    MatrixCity's test folder,
  * the spheric test trajectory.

Images decode without PIL or imageio: PNG files (plain and Adam7, the row
filters undone in C) through utils/png.py and JPEG files, baseline and
progressive, through utils/jpeg.py (a C decoder equal to PIL's libjpeg
decode bit for bit). Only a JPEG that decoder does not implement (CMYK,
12-bit, lossless, arithmetic-coded, a progressive file that libjpeg would
smooth) and other formats need PIL, imported at the call; where it is
missing they raise naming the file. Resizes run in torch
(`interpolate(mode="bilinear", antialias=True)`, which follows PIL's
BILINEAR filter; the result differs from PIL's uint8 resize by at most one
8-bit level), and the caches are written by the port's PNG writer. The
port writes its caches only under directories of its own
(`images_{factor}_torch/`, `<dir>_undist_torch/`), which dogs_tpu never
reads: a minified JPEG there keeps its file name and holds PNG data
(readers go by the file's signature, not its extension). Without a cache of
its own it reads a dataset's own `images_{factor}/` where one exists, as
dogs_tpu does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from dogs_tpu_torch.core.camera import Camera, make_camera
from dogs_tpu_torch.data.colmap import ColmapModel, load_model
from dogs_tpu_torch.utils import jpeg, png

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CameraRecord:
    """Host-side camera: geometry + lazily-loaded image."""

    R: np.ndarray  # (3,3) world->cam
    t: np.ndarray  # (3,)
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    image_path: str
    image_index: int
    # (k1, k2, p1, p2) lens distortion, None = pinhole
    dist: np.ndarray | None = None

    def to_camera(self, device: torch.device | str = "cuda") -> Camera:
        return make_camera(
            self.R, self.t, self.fx, self.fy, self.cx, self.cy,
            self.width, self.height, image_index=self.image_index, device=device,
        )

    @property
    def center(self) -> np.ndarray:
        return -self.R.T @ self.t

    def load(self) -> np.ndarray:
        """Decode this record's GT image at the record's exact resolution,
        undistorted: a factor > 1 scene without a minify cache resizes here
        (the intrinsics are already scaled, so the pixels must match)."""
        img = load_image(self.image_path)
        if img.shape[0] != self.height or img.shape[1] != self.width:
            img = resize_image(img, self.width, self.height)
        if self.dist is not None:
            img = undistort_image(img, self.fx, self.fy, self.cx, self.cy, self.dist)
        return img


def similarity_from_cameras(c2w: np.ndarray):
    """Similarity transform (R, t, s) normalizing camera poses:
    (1) rotate so the average camera -y (world up) aligns with +z,
    (2) translate the camera centroid to the origin,
    (3) scale by 1 / (median distance).
    c2w: (N, 4, 4) camera-to-world.
    """
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    # World up: average of camera up vectors (-y column in COLMAP convention).
    ups = -R[:, :, 1]
    up = ups.mean(axis=0)
    up /= np.linalg.norm(up) + 1e-12

    # Rotation taking `up` to +z.
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(up, z)
    c = float(up @ z)
    if np.linalg.norm(v) < 1e-8:
        R_align = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R_align = np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))

    t_rot = t @ R_align.T
    t_center = t_rot.mean(axis=0)
    dists = np.linalg.norm(t_rot - t_center, axis=-1)
    scale = 1.0 / max(float(np.median(dists)), 1e-8)
    return R_align, -t_center, scale


@dataclasses.dataclass
class SceneData:
    train_cameras: list[CameraRecord]
    val_cameras: list[CameraRecord]
    points: np.ndarray  # (P, 3) normalized
    colors: np.ndarray  # (P, 3) in [0, 1]
    transform: np.ndarray  # (4, 4) applied world transform (for export)
    scale: float


def _normalize_scene(records: list[CameraRecord], points: np.ndarray, do_rotate: bool, do_scale: bool):
    c2w = np.stack(
        [np.block([[r.R.T, r.center[:, None]], [np.zeros((1, 3)), np.ones((1, 1))]]) for r in records]
    )
    R_align, t_align, s = similarity_from_cameras(c2w)
    if not do_rotate:
        R_align = np.eye(3)
        t_align = -np.stack([r.center for r in records]).mean(axis=0)
    if not do_scale:
        s = 1.0

    transform = np.eye(4)
    transform[:3, :3] = s * R_align
    transform[:3, 3] = s * t_align

    # new_world = s * (R_align @ w + t_align): rotations stay orthonormal and
    # the scale folds into the translations (points and cameras scale alike).
    for r in records:
        c_new = s * (R_align @ r.center + t_align)
        R_new = r.R @ R_align.T
        r.R = R_new
        r.t = -R_new @ c_new
    points = s * (points @ R_align.T + t_align)
    return records, points, transform, s


MANHATTAN_SWAP = np.array(
    # COLMAP's model_orientation_aligner leaves y pointing down; swap axes so
    # z points at the ground plane.
    [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]]
)


def load_scene(
    root_dir: str,
    factor: int = 1,
    val_interval: int = 8,
    model_folder: str = "sparse",
    normalize: bool = True,
    use_manhattan_world: bool = False,
    scene_name: str | None = None,
    dataset_name: str | None = None,
) -> SceneData:
    """Load a COLMAP scene directory laid out as
    <root>/<model_folder>/0/{cameras,images,points3D}.bin and <root>/images/,
    with dogs_tpu's rules: the minification cache made on demand; the
    manhattan-world model folder and axis swap; the Mega-NeRF val-list and
    MatrixCity test-folder split rules; lens distortion recorded per camera
    and removed through the undistortion cache."""
    scene_name = scene_name or os.path.basename(os.path.normpath(root_dir))
    model_dir = os.path.join(root_dir, model_folder)
    if use_manhattan_world and os.path.isdir(os.path.join(model_dir, "manhattan_world")):
        model_dir = os.path.join(model_dir, "manhattan_world")
    elif os.path.isdir(os.path.join(model_dir, "0")):
        model_dir = os.path.join(model_dir, "0")
    model: ColmapModel = load_model(model_dir)

    image_dir = minify_images(root_dir, factor)

    records: list[CameraRecord] = []
    colmap_names: list[str] = []
    for idx, iid in enumerate(sorted(model.images.keys())):
        im = model.images[iid]
        colmap_names.append(im.name)
        cam = model.cameras[im.camera_id]
        # Match minify's output sizes exactly (ceil), and scale intrinsics
        # by the realized per-axis ratio rather than assuming 1/factor.
        new_w = -(-cam.width // factor)
        new_h = -(-cam.height // factor)
        sx = new_w / cam.width
        sy = new_h / cam.height
        records.append(
            CameraRecord(
                R=im.rotation(),
                t=im.tvec.astype(np.float64),
                fx=cam.fx * sx,
                fy=cam.fy * sy,
                cx=cam.cx * sx,
                cy=cam.cy * sy,
                width=int(new_w),
                height=int(new_h),
                image_path=os.path.join(image_dir, im.name),
                image_index=idx,
                dist=distortion_coeffs(cam.model, cam.params),
            )
        )

    undistort_cache(records, image_dir)

    points = model.points_xyz.copy()
    colors = model.points_rgb.astype(np.float64) / 255.0

    if use_manhattan_world and scene_name.lower() != "building":
        # The `building` scene comes out of the aligner already z-down.
        T = MANHATTAN_SWAP
        for r in records:
            c_new = T @ r.center
            R_new = r.R @ T.T
            r.R = R_new
            r.t = -R_new @ c_new
        points = points @ T.T

    transform = np.eye(4)
    scale = 1.0
    if normalize:
        records, points, transform, scale = _normalize_scene(records, points, do_rotate=True, do_scale=True)

    # Split: Mega-NeRF scenes use the published val image lists; MatrixCity
    # marks val by the test folder in the image name (detected from the
    # config's dataset name, or the directory name for name-less callers);
    # otherwise every val_interval-th image.
    val_names = meganerf_val_names(root_dir, scene_name)
    is_matrix_city = (
        (dataset_name or "").replace("_", "").lower() == "matrixcity"
        or "MatrixCity" in root_dir
        or "matrix_city" in root_dir
    )

    def is_val(i: int, rec: CameraRecord) -> bool:
        if val_names is not None:
            return os.path.basename(rec.image_path) in val_names
        if is_matrix_city:
            return "test" in colmap_names[i]
        return val_interval > 0 and i % val_interval == 0

    train, val = [], []
    for i, rec in enumerate(records):
        (val if is_val(i, rec) else train).append(rec)

    return SceneData(
        train_cameras=train,
        val_cameras=val,
        points=points.astype(np.float32),
        colors=colors.astype(np.float32),
        transform=transform,
        scale=scale,
    )


def _resize(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W[, C]) numbers -> (height, width[, C]) float32: torch's
    antialiased bilinear resize, which follows PIL's BILINEAR filter."""
    x = torch.from_numpy(np.asarray(arr, np.float32))
    grey = x.dim() == 2
    x = (x[None] if grey else x.permute(2, 0, 1))[None]
    out = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=True)[0]
    return (out[0] if grey else out.permute(1, 2, 0)).numpy()


def _to_dtype(arr: np.ndarray, dtype) -> np.ndarray:
    """Round to the nearest integer of `dtype`, clipped to its range."""
    return np.clip(np.rint(arr), 0, np.iinfo(dtype).max).astype(dtype)


def resize_image(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """A float [0, 1] image resized as dogs_tpu resizes it: quantized to 8
    bits (truncating), resized (`_resize`), rounded to 8 bits, back to
    float32 [0, 1]."""
    arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return _to_dtype(_resize(arr, width, height), np.uint8).astype(np.float32) / 255.0


def undistort_image(
    img: np.ndarray, fx: float, fy: float, cx: float, cy: float, dist: np.ndarray,
) -> np.ndarray:
    """Undistort to the same pinhole K: for every undistorted target pixel,
    apply the FORWARD distortion model (k1, k2, p1, p2 — COLMAP
    SIMPLE_RADIAL/RADIAL/OPENCV conventions) to find its source pixel and
    bilinearly sample (numpy, as dogs_tpu)."""
    k1, k2, p1, p2 = [float(v) for v in dist]
    if k1 == k2 == p1 == p2 == 0.0:
        return img
    h, w = img.shape[:2]
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x = (u - cx) / fx
    y = (v - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + k2 * r2)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    us = xd * fx + cx
    vs = yd * fy + cy
    # Bilinear sample with edge clamp.
    u0 = np.clip(np.floor(us).astype(np.int32), 0, w - 2)
    v0 = np.clip(np.floor(vs).astype(np.int32), 0, h - 2)
    du = np.clip(us - u0, 0.0, 1.0)[..., None]
    dv = np.clip(vs - v0, 0.0, 1.0)[..., None]
    p00 = img[v0, u0]
    p01 = img[v0, u0 + 1]
    p10 = img[v0 + 1, u0]
    p11 = img[v0 + 1, u0 + 1]
    out = p00 * (1 - du) * (1 - dv) + p01 * du * (1 - dv) + p10 * (1 - du) * dv + p11 * du * dv
    inside = (us >= 0) & (us <= w - 1) & (vs >= 0) & (vs <= h - 1)
    return np.where(inside[..., None], out, 0.0).astype(np.float32)


def distortion_coeffs(model: str, params: np.ndarray) -> np.ndarray | None:
    """COLMAP camera model -> (k1,k2,p1,p2), or None when pinhole/zero."""
    if model == "SIMPLE_RADIAL":
        d = np.array([params[3], 0.0, 0.0, 0.0])
    elif model == "RADIAL":
        d = np.array([params[3], params[4], 0.0, 0.0])
    elif model in ("OPENCV", "FULL_OPENCV"):
        d = np.asarray(params[4:8], np.float64)
    else:  # SIMPLE_PINHOLE / PINHOLE / fisheye models (not corrected)
        return None
    return d if np.any(d != 0.0) else None


IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")


# Suffix of the directories the port writes its caches to: dogs_tpu reads
# and writes `images_{factor}/` and `<dir>_undist/` with PIL, and never
# reads these.
CACHE_SUFFIX = "_torch"


# Threads of the minify (the C decoders, zlib and the resize release the
# interpreter lock), as many as the lazy reader's.
MINIFY_THREADS = 8


def minify_images(root_dir: str, factor: int) -> str:
    """The images at 1 / factor: the port's cache `images_{factor}_torch/`
    where it exists, else the dataset's own `images_{factor}/` where that
    exists, else the port's cache, generated now on MINIFY_THREADS threads: every
    image of `images/` resized to ceil(size / factor) with its channels and
    bit depth (`_resize`, rounded), written as PNG data under its own name,
    subdirectories kept. Returns the directory (the source for factor 1 or
    a missing source)."""
    src = os.path.join(root_dir, "images")
    if factor == 1 or not os.path.isdir(src):
        return src
    dst = src + f"_{factor}" + CACHE_SUFFIX
    for d in (dst, src + f"_{factor}"):
        if os.path.isdir(d):
            return d
    tmp = dst + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    jobs = []
    for dirpath, _, files in os.walk(src):
        rel = os.path.relpath(dirpath, src)
        for fname in files:
            if not fname.endswith(IMAGE_EXTS):
                continue
            out_dir = os.path.join(tmp, rel) if rel != "." else tmp
            os.makedirs(out_dir, exist_ok=True)
            jobs.append((os.path.join(dirpath, fname), os.path.join(out_dir, fname)))

    def minify(job: tuple[str, str]) -> None:
        img = decode_image(job[0])
        h, w = img.shape[:2]
        png.write_png(job[1], _to_dtype(_resize(img, -(-w // factor), -(-h // factor)), img.dtype))

    with ThreadPoolExecutor(MINIFY_THREADS) as pool:
        for _ in pool.map(minify, jobs):  # raises the first failed image's error
            pass
    os.replace(tmp, dst)
    logger.info("minified %d images into %s", len(jobs), dst)
    return dst


def undistort_cache(records: list[CameraRecord], image_dir: str) -> None:
    """One-time undistortion cache `<image_dir>_undist_torch/`: each distorted
    record's image is decoded at its working resolution, undistorted once,
    stored as 8-bit PNG, and the record is repointed at the cache with
    `dist` cleared so `load()` skips the remap."""
    pending = [r for r in records if r.dist is not None]
    if not pending:
        return
    dst = os.path.normpath(image_dir) + "_undist" + CACHE_SUFFIX

    def cache_path(r: CameraRecord) -> str:
        rel = os.path.relpath(r.image_path, image_dir)
        return os.path.join(dst, os.path.splitext(rel)[0] + ".png")

    if not os.path.isdir(dst):
        tmp = dst + ".tmp"
        for r in pending:
            img = load_image(r.image_path)
            if img.shape[0] != r.height or img.shape[1] != r.width:
                img = resize_image(img, r.width, r.height)
            img = undistort_image(img, r.fx, r.fy, r.cx, r.cy, r.dist)
            rel = os.path.relpath(r.image_path, image_dir)
            out = os.path.join(tmp, os.path.splitext(rel)[0] + ".png")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            png.write_png(out, np.clip(img * 255.0, 0, 255).astype(np.uint8))
        os.replace(tmp, dst)
        logger.info("undistorted %d images into %s", len(pending), dst)
    for r in pending:
        p = cache_path(r)
        if os.path.isfile(p):  # partial caches fall back to per-load remap
            r.image_path = p
            r.dist = None


# Mega-NeRF-preprocessed scenes select val images from the val/ folder
# instead of every-kth.
MEGA_NERF_PREPROCESSED_SCENE = ("rubble", "building")
MEGA_NERF_PREPROCESSED_SCENE_WITH_MAPPINGS = ("Residence", "Campus", "Sci-Art")


def meganerf_val_names(root_dir: str, scene_name: str) -> set[str] | None:
    """Basenames of the val images, per the Mega-NeRF layout, or None."""
    val_dir = os.path.join(root_dir, "val")
    if scene_name in MEGA_NERF_PREPROCESSED_SCENE_WITH_MAPPINGS:
        meta_dir = os.path.join(val_dir, "metadata")
        mappings = os.path.join(root_dir, "mappings.txt")
        if not (os.path.isdir(meta_dir) and os.path.exists(mappings)):
            return None
        meta_to_img = {}
        with open(mappings, encoding="utf-8") as f:
            for line in f:
                if "," in line:
                    img, meta = line.split(",", 1)
                    meta_to_img[meta.strip()] = img.strip()
        names = set()
        for fname in os.listdir(meta_dir):
            stem = os.path.splitext(fname)[0]
            for key, img in meta_to_img.items():
                if os.path.splitext(key)[0] == stem:
                    names.add(os.path.basename(img))
        return names or None
    if scene_name in MEGA_NERF_PREPROCESSED_SCENE:
        rgb_dir = os.path.join(val_dir, "rgbs")
        if not os.path.isdir(rgb_dir):
            return None
        return {os.path.basename(p) for p in os.listdir(rgb_dir) if p.endswith(IMAGE_EXTS)} or None
    return None


def decode_image(path: str) -> np.ndarray:
    """The file's pixels as stored (uint8 or uint16, (H, W[, C])), by the
    file's signature, whatever its name: PNG data through utils/png.py,
    JPEG data, baseline or progressive, through utils/jpeg.py (a truncated
    or corrupt JPEG raises ValueError). A JPEG that decoder does not
    implement (`UnsupportedJpeg`: CMYK, 12-bit, lossless, arithmetic-coded,
    a progressive file libjpeg would smooth) and any other format go to PIL,
    and raise naming the file where PIL is missing."""
    if png.is_png(path):
        return png.read_png(path)
    reason = f"{path}: neither PNG nor JPEG data"
    if jpeg.is_jpeg(path):
        try:
            return jpeg.read_jpeg(path)
        except jpeg.UnsupportedJpeg as e:  # its message names the file and the process
            reason = str(e)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{reason}; PIL, which would decode it, is not installed") from e
    logger.info("%s; decoding it with PIL", reason)
    with Image.open(path) as im:
        return np.asarray(im)


def load_image(path: str) -> np.ndarray:
    """Read an image to float32 [0,1] HWC: uint8 / 255, uint16 / 65535, grey
    to RGB, RGBA composited over white."""
    img = decode_image(path)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        # Composite over white like blender data handling.
        rgb, a = img[..., :3], img[..., 3:4]
        img = rgb * a + (1.0 - a)
    return img[..., :3].astype(np.float32)


def spheric_test_poses(n_poses: int, radius: float, height: float = -0.5) -> np.ndarray:
    """(n_poses, 4, 4) float64 camera-to-world matrices on a circle of
    `radius` at `height`, looking at the origin (dogs_tpu's copy of the
    reference's create_spheric_poses)."""
    c2ws = []
    for theta in np.linspace(0.0, 2.0 * np.pi, n_poses, endpoint=False):
        eye = np.array([radius * np.cos(theta), height, radius * np.sin(theta)])
        forward = -eye / np.linalg.norm(eye)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, down, forward], axis=1)
        c2w[:3, 3] = eye
        c2ws.append(c2w)
    return np.stack(c2ws)
