"""Minimal binary-little-endian PLY reader/writer (plyfile replacement).

The port's copy of dogs_tpu/data/ply.py (numpy only), so that the port's
exports are byte-equal to dogs_tpu's. The reference uses the `plyfile`
package for Gaussian I/O (gaussian_splat_model.py:616-666 save_ply /
save_colmap_ply and the point-cloud fetch in
conerf/datasets/utils.py:372-397); this is the subset of PLY that 3DGS
tooling uses: binary/ascii vertex-element files with float/uchar
properties.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "float": ("f4", 4),
    "float32": ("f4", 4),
    "double": ("f8", 8),
    "float64": ("f8", 8),
    "uchar": ("u1", 1),
    "uint8": ("u1", 1),
    "char": ("i1", 1),
    "short": ("i2", 2),
    "ushort": ("u2", 2),
    "int": ("i4", 4),
    "int32": ("i4", 4),
    "uint": ("u4", 4),
    "uint32": ("u4", 4),
}
_INV_TYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int", "u4": "uint"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the 'vertex' element into a dict of 1-D property arrays."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = None
    n_vertex = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n_vertex = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported on vertex element")
            props.append((parts[2], _TYPES[parts[1]][0]))

    if fmt == "ascii":
        rows = np.loadtxt(
            [ln for ln in body.decode("ascii").splitlines() if ln.strip()],
            ndmin=2,
        )[:n_vertex]
        return {name: rows[:, i].astype(dt) for i, (name, dt) in enumerate(props)}

    endian = "<" if fmt == "binary_little_endian" else ">"
    dtype = np.dtype([(name, endian + dt) for name, dt in props])
    arr = np.frombuffer(body, dtype=dtype, count=n_vertex)
    return {name: np.ascontiguousarray(arr[name]) for name, _ in props}


def write_ply(path: str, properties: dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian PLY with a single vertex element."""
    names = list(properties.keys())
    n = len(next(iter(properties.values())))
    cols = []
    dtypes = []
    for name in names:
        a = np.asarray(properties[name])
        if a.shape != (n,):
            raise ValueError(f"PLY property {name}: shape {a.shape}, expected ({n},)")
        kind = a.dtype.str.lstrip("<>|=")
        if kind not in _INV_TYPES:
            a = a.astype(np.float32)
            kind = "f4"
        cols.append(a)
        dtypes.append((name, "<" + kind))

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name, dt in dtypes:
        header.append(f"property {_INV_TYPES[dt.lstrip('<')]} {name}")
    header.append("end_header")

    rec = np.empty(n, dtype=np.dtype(dtypes))
    for name, col in zip(names, cols):
        rec[name] = col
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def read_point_cloud(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(xyz, rgb01) from a PLY with x/y/z (+red/green/blue) properties."""
    props = read_ply(path)
    xyz = np.stack([props["x"], props["y"], props["z"]], axis=-1).astype(np.float64)
    if "red" in props:
        rgb = np.stack([props["red"], props["green"], props["blue"]], axis=-1)
        rgb = rgb.astype(np.float64)
        if rgb.max() > 1.0:
            rgb = rgb / 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    return xyz, rgb


def write_point_cloud(path: str, xyz: np.ndarray, rgb01: np.ndarray) -> None:
    rgb = np.clip(np.asarray(rgb01) * 255.0, 0, 255).astype(np.uint8)
    write_ply(
        path,
        {
            "x": np.asarray(xyz[:, 0], np.float32),
            "y": np.asarray(xyz[:, 1], np.float32),
            "z": np.asarray(xyz[:, 2], np.float32),
            "red": rgb[:, 0],
            "green": rgb[:, 1],
            "blue": rgb[:, 2],
        },
    )
