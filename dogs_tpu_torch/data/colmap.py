"""COLMAP model reader/writer (cameras / images / points3D, bin + txt).

Port of dogs_tpu/data/colmap.py, numpy only (the native C helper of
dogs_tpu/data/native.py is not used). Binary layouts follow the COLMAP
documentation:
  cameras.bin : [n:u64] then per camera [id:i32, model:i32, w:u64, h:u64,
                params:f64 x model_n_params]
  images.bin  : [n:u64] then per image [id:i32, qvec:4xf64, tvec:3xf64,
                camera_id:i32, name:cstr, n_pts:u64, (x:f64, y:f64,
                p3d_id:i64) x n_pts]
  points3D.bin: [n:u64] then per point [id:u64, xyz:3xf64, rgb:3xu8,
                error:f64, track_len:u64, (image_id:i32, p2d_idx:i32) x len]

`read_points3d_bin` walks only the track lengths in Python and reads the
fixed fields of every point with one gather over their offsets.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
# Models whose parameters start (f, cx, cy): one focal length.
_ONE_FOCAL = ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL", "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV")


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    @property
    def fx(self) -> float:
        return float(self.params[0])

    @property
    def fy(self) -> float:
        return float(self.params[0] if self.model in _ONE_FOCAL else self.params[1])

    @property
    def cx(self) -> float:
        return float(self.params[1] if self.model in _ONE_FOCAL else self.params[2])

    @property
    def cy(self) -> float:
        return float(self.params[2] if self.model in _ONE_FOCAL else self.params[3])


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) wxyz, world->camera
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str

    def rotation(self) -> np.ndarray:
        w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )


@dataclasses.dataclass
class ColmapModel:
    cameras: dict[int, ColmapCamera]
    images: dict[int, ColmapImage]
    points_xyz: np.ndarray  # (P, 3) float64
    points_rgb: np.ndarray  # (P, 3) uint8
    points_err: np.ndarray  # (P,) float64


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, fmt: str):
        out = struct.unpack_from("<" + fmt, self.data, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return out

    def read_array(self, dtype, count):
        arr = np.frombuffer(self.data, dtype=dtype, count=count, offset=self.pos)
        self.pos += arr.nbytes
        return arr

    def read_cstr(self) -> str:
        end = self.data.index(b"\x00", self.pos)
        s = self.data[self.pos : end].decode("utf-8")
        self.pos = end + 1
        return s


def read_cameras_bin(path: str) -> dict[int, ColmapCamera]:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    (n,) = r.read("Q")
    out = {}
    for _ in range(n):
        cid, model_id = r.read("ii")
        w, h = r.read("QQ")
        name, n_params = CAMERA_MODELS[model_id]
        params = r.read_array(np.float64, n_params).copy()
        out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> dict[int, ColmapImage]:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    (n,) = r.read("Q")
    out = {}
    for _ in range(n):
        (iid,) = r.read("i")
        qvec = r.read_array(np.float64, 4).copy()
        tvec = r.read_array(np.float64, 3).copy()
        (cam_id,) = r.read("i")
        name = r.read_cstr()
        (n_pts,) = r.read("Q")
        r.pos += int(n_pts) * 24  # skip 2D observations (x, y, p3d_id)
        out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name)
    return out


# The fixed 43 bytes that start every points3D.bin record, then track_len:u64.
_POINT_HEAD = np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)), ("err", "<f8")])
_TRACK_LEN_AT = _POINT_HEAD.itemsize


def read_points3d_bin(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xyz float64 (P, 3), rgb uint8 (P, 3), error float64 (P,))."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    offsets = np.empty((n,), np.int64)
    pos, unpack = 8, struct.Struct("<Q").unpack_from
    for i in range(n):  # the records' lengths depend on their track lengths
        offsets[i] = pos
        pos += _TRACK_LEN_AT + 8 + 8 * unpack(data, pos + _TRACK_LEN_AT)[0]
    raw = np.frombuffer(data, np.uint8)
    heads = raw[offsets[:, None] + np.arange(_TRACK_LEN_AT)].view(_POINT_HEAD)[:, 0]
    return heads["xyz"].copy(), heads["rgb"].copy(), heads["err"].copy()


def read_cameras_txt(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            out[cid] = ColmapCamera(
                cid, parts[1], int(parts[2]), int(parts[3]), np.asarray([float(p) for p in parts[4:]]),
            )
    return out


def read_images_txt(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if not ln.lstrip().startswith("#")]
    # Two lines per image: header, then the 2D-observation line (may be blank).
    i = 0
    while i < len(lines):
        header = lines[i].strip()
        i += 1
        if not header:
            continue
        parts = header.split()
        iid = int(parts[0])
        qvec = np.asarray([float(p) for p in parts[1:5]])
        tvec = np.asarray([float(p) for p in parts[5:8]])
        out[iid] = ColmapImage(iid, qvec, tvec, int(parts[8]), parts[9])
        i += 1  # skip the observations line, even when blank
    return out


def read_points3d_txt(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz.append([float(p) for p in parts[1:4]])
            rgb.append([int(p) for p in parts[4:7]])
            err.append(float(parts[7]))
    return (
        np.asarray(xyz, np.float64).reshape(-1, 3),
        np.asarray(rgb, np.uint8).reshape(-1, 3),
        np.asarray(err, np.float64),
    )


def load_model(model_dir: str) -> ColmapModel:
    """Load a COLMAP model directory, preferring .bin over .txt."""

    def pick(base):
        b = os.path.join(model_dir, base + ".bin")
        t = os.path.join(model_dir, base + ".txt")
        if os.path.exists(b):
            return b, True
        if os.path.exists(t):
            return t, False
        raise FileNotFoundError(f"{base}.bin/.txt not found in {model_dir}")

    cam_path, cam_bin = pick("cameras")
    img_path, img_bin = pick("images")
    pts_path, pts_bin = pick("points3D")
    cameras = read_cameras_bin(cam_path) if cam_bin else read_cameras_txt(cam_path)
    images = read_images_bin(img_path) if img_bin else read_images_txt(img_path)
    xyz, rgb, err = read_points3d_bin(pts_path) if pts_bin else read_points3d_txt(pts_path)
    return ColmapModel(cameras, images, xyz, rgb, err)


# ---- writers ------------------------------------------------------------------


def write_cameras_bin(path: str, cameras: dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.camera_id, mid, cam.width, cam.height))
            f.write(np.asarray(cam.params, np.float64).tobytes())


def write_images_bin(path: str, images: dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(np.asarray(im.qvec, np.float64).tobytes())
            f.write(np.asarray(im.tvec, np.float64).tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D observations


def write_points3d_bin(path: str, xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray | None = None) -> None:
    """The bytes of dogs_tpu's writer (ids 1..P, empty tracks), written as
    one array of records."""
    n = xyz.shape[0]
    rec = np.zeros((n,), np.dtype(_POINT_HEAD.descr + [("track_len", "<u8")]))
    rec["id"] = np.arange(1, n + 1)
    rec["xyz"] = np.asarray(xyz, np.float64)
    rec["rgb"] = np.asarray(rgb, np.uint8)
    rec["err"] = 0.0 if err is None else np.asarray(err, np.float64)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(rec.tobytes())


def write_model_txt(
    model_dir: str,
    cameras: dict[int, ColmapCamera],
    images: dict[int, ColmapImage],
    xyz: np.ndarray,
    rgb: np.ndarray,
) -> None:
    """Text-format export (dogs_tpu's write_model_txt)."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(str(float(p)) for p in cam.params)
            f.write(f"{cam.camera_id} {cam.model} {cam.width} {cam.height} {params}\n")
    with open(os.path.join(model_dir, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for im in images.values():
            q = " ".join(str(float(v)) for v in im.qvec)
            t = " ".join(str(float(v)) for v in im.tvec)
            f.write(f"{im.image_id} {q} {t} {im.camera_id} {im.name}\n\n")
    with open(os.path.join(model_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        for i in range(xyz.shape[0]):
            x, y, z = (float(v) for v in xyz[i])
            r, g, b = (int(v) for v in rgb[i])
            f.write(f"{i + 1} {x} {y} {z} {r} {g} {b} 0.0\n")
