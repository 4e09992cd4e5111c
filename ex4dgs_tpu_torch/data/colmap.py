"""COLMAP binary/text model parsing.

Re-implementation of the standard COLMAP output format readers
(scene/colmap_loader.py:43-294 in the reference; the format itself is COLMAP's
public spec). Pure numpy/struct, host-side.

Counterpart of `ex4dgs_tpu/data/colmap.py` (the same readers; its
`rotmat2qvec`, used only by the preprocess pipeline, is not ported yet).
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


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


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """The unit quaternion (w, x, y, z, w >= 0) of rotation matrix R."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path) -> dict:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path) -> dict:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, 8, "Q")
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64).reshape(-1, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].astype(np.int64)
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode("utf-8"),
                                   xys, ids)
    return out


def read_points3d_binary(path):
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3))
        err = np.empty((num, 1))
        for i in range(num):
            _pid = _read(f, 8, "Q")[0]
            xyz[i] = _read(f, 24, "ddd")
            rgb[i] = _read(f, 3, "BBB")
            err[i] = _read(f, 8, "d")[0]
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, 1)
    return xyz, rgb, err


def read_cameras_text(path) -> dict:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cid = int(el[0])
            cams[cid] = ColmapCamera(
                cid, el[1], int(el[2]), int(el[3]), np.array(el[4:], dtype=np.float64)
            )
    return cams


def read_images_text(path) -> dict:
    """COLMAP images.txt: each image is a pose line (ends in a filename)
    optionally followed by a points2D line (all-numeric, possibly empty —
    empty ones vanish under blank-line stripping, so detect by structure)."""
    out = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]

    def is_pose_line(el):
        if len(el) < 10:
            return False
        try:
            float(el[9])
            return False  # 10th field numeric -> points2D line
        except ValueError:
            return True  # filename

    i = 0
    while i < len(lines):
        el = lines[i].split()
        if not is_pose_line(el):
            raise ValueError(f"malformed images.txt line: {lines[i]!r}")
        iid = int(el[0])
        qvec = np.array(el[1:5], dtype=np.float64)
        tvec = np.array(el[5:8], dtype=np.float64)
        cam_id = int(el[8])
        name = el[9]
        i += 1
        el2 = []
        if i < len(lines) and not is_pose_line(lines[i].split()):
            el2 = lines[i].split()
            i += 1
        xys = np.array(el2, dtype=np.float64).reshape(-1, 3)[:, :2] if el2 else np.zeros((0, 2))
        ids = (np.array(el2, dtype=np.float64).reshape(-1, 3)[:, 2].astype(np.int64)
               if el2 else np.zeros((0,), np.int64))
        out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, ids)
    return out


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([float(x) for x in el[4:7]])
            err.append(float(el[7]))
    return np.array(xyz), np.array(rgb), np.array(err).reshape(-1, 1)


def read_model(sparse_dir: str):
    """Read (cameras, images, points) preferring binary."""
    import os

    if os.path.exists(os.path.join(sparse_dir, "images.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
    return cams, imgs
