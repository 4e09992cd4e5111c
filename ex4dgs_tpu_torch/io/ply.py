"""Self-contained PLY reading/writing (binary little-endian + ascii).

Counterpart of `ex4dgs_tpu/io/ply.py` (the same code: numpy only).

Covers the three layouts the reference uses: the colored init cloud
(x..z, nx..nz, red/green/blue — dataset_readers.py:334-349), the static
splat export (f_dc_*, f_rest_*, opacity, scale_*, rot_*, xyz_disp_* —
c_gaussian_model.py:473-531), and the dynamic splat export (motion_* —
:490-547). No external plyfile dependency.
"""
from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "u2", "uint16": "u2", "short": "i2", "int16": "i2",
    "uint": "u4", "uint32": "u4", "int": "i4", "int32": "i4",
}


def read_ply(path: str) -> np.ndarray:
    """Read the first (vertex) element of a PLY file into a structured array."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n = None
        props = []
        in_vertex = False
        for line in header:
            if line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list properties unsupported in vertex element")
                props.append((parts[2], _PLY_TO_NP[parts[1]]))
        if n is None:
            raise ValueError(f"{path}: no vertex element found")
        dtype = np.dtype([(name, ("<" if fmt == "binary_little_endian" else ">") + t)
                          for name, t in props]) if fmt != "ascii" else None
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            out = np.zeros(n, dtype=np.dtype([(name, t) for name, t in props]))
            for i, (name, _t) in enumerate(props):
                out[name] = data[:, i] if data.ndim > 1 else data
            return out
        return np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)


def write_ply(path: str, arrays: dict, dtypes: dict | None = None) -> None:
    """Write named columns (same length) as a binary little-endian vertex PLY."""
    names = list(arrays)
    n = len(next(iter(arrays.values())))
    dtype = np.dtype([
        (k, (dtypes or {}).get(k, "<f4")) for k in names
    ])
    rec = np.empty(n, dtype=dtype)
    for k in names:
        rec[k] = arrays[k]
    np_to_ply = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int"}
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k in names:
            t = np_to_ply[dtype[k].str[1:]]
            f.write(f"property {t} {k}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def read_basic_ply(path: str):
    """Colored point cloud -> (points [N,3] f32, colors [N,3] in [0,1])."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    cols = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32)
    if cols.max() > 1.0:
        cols = cols / 255.0
    return pts, cols


def write_basic_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Colored cloud with zero normals (dataset_readers.py:334-349 layout)."""
    rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8) if rgb.dtype != np.uint8 else rgb
    zeros = np.zeros(xyz.shape[0], np.float32)
    write_ply(
        path,
        {
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "nx": zeros, "ny": zeros, "nz": zeros,
            "red": rgb8[:, 0], "green": rgb8[:, 1], "blue": rgb8[:, 2],
        },
        dtypes={"red": "u1", "green": "u1", "blue": "u1"},
    )
