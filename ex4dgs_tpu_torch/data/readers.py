"""Dataset readers: Neural3DVideo, Technicolor, generic COLMAP.

Behavioral mirror of scene/dataset_readers.py:35-586:
  * N3V: per-camera frame directories (camXX/0000.png...), test split is every
    frame of cam00 (:541-542); near/far fixed 0.01/300 (:533-534).
  * Technicolor: flat `*_<t>_<cam>.png` files, test camera `_10`, camera
    translations and the init point cloud normalized by the nerf++ radius,
    then radius := 1 (:487-509); near/far 0.01/100.
  * COLMAP: llffhold split (:368-373).

Counterpart of `ex4dgs_tpu/data/readers.py` (the same code).
"""
from __future__ import annotations

import glob
import os
import re
from typing import Callable, NamedTuple

import numpy as np

from ..io.ply import read_basic_ply
from ..ops.math3d import focal2fov, world_to_view
from .cameras import CameraInfo
from .colmap import qvec2rotmat, read_model, read_points3d_binary, read_points3d_text


class PointCloud(NamedTuple):
    points: np.ndarray  # [N, 3]
    colors: np.ndarray  # [N, 3] in [0, 1]


class SceneInfo(NamedTuple):
    point_cloud: PointCloud
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


def nerfpp_norm(cam_infos) -> dict:
    """Camera-centroid radius normalization (dataset_readers.py:87-108)."""
    centers = []
    for cam in cam_infos:
        W2C = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(W2C)[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.linalg.norm(centers - avg, axis=0).max()
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def _intrinsics_to_fov(intr):
    if intr.model == "SIMPLE_PINHOLE":
        fx = fy = intr.params[0]
    elif intr.model == "PINHOLE":
        fx, fy = intr.params[0], intr.params[1]
    else:
        raise ValueError(
            f"unsupported COLMAP camera model {intr.model}: only undistorted "
            "PINHOLE/SIMPLE_PINHOLE datasets are supported"
        )
    return focal2fov(fx, intr.width), focal2fov(fy, intr.height), fx, fy


def _load_points(sparse_dir: str, transform=None) -> tuple[PointCloud, str]:
    ply_path = os.path.join(sparse_dir, "points3D.ply")
    bin_path = os.path.join(sparse_dir, "points3D.bin")
    txt_path = os.path.join(sparse_dir, "points3D.txt")
    if os.path.exists(ply_path):
        pts, cols = read_basic_ply(ply_path)
    else:
        if os.path.exists(bin_path):
            pts, cols, _ = read_points3d_binary(bin_path)
        else:
            pts, cols, _ = read_points3d_text(txt_path)
        cols = cols / 255.0
        if transform is not None:
            pts = transform(pts)
    pc = PointCloud(points=np.asarray(pts, np.float32),
                    colors=np.asarray(cols, np.float32))
    return pc, ply_path


def read_n3v_scene(path: str, cfg) -> SceneInfo:
    """Neural 3D Video scene (dataset_readers.py:520-579)."""
    colmap_path = os.path.join(path, f"colmap_{int(cfg.start_timestamp)}")
    cams, imgs = read_model(os.path.join(colmap_path, "sparse", "0"))
    near, far = 0.01, 300.0

    infos = []
    for key in imgs:
        extr = imgs[key]
        intr = cams[extr.camera_id]
        fovx, fovy, _, _ = _intrinsics_to_fov(intr)
        R = qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        cam_dir = os.path.join(path, extr.name[:-4])
        frame_paths = sorted(
            glob.glob(cam_dir + "/*.png"),
            key=lambda x: int(os.path.basename(x)[:-4]),
        )
        for j, image_path in enumerate(frame_paths):
            if j < cfg.start_timestamp or (
                cfg.end_timestamp != -1 and j >= cfg.end_timestamp
            ):
                continue
            infos.append(CameraInfo(
                uid=intr.id, R=R, T=T, fovx=fovx, fovy=fovy,
                image_path=image_path, image_name=os.path.basename(image_path),
                width=intr.width, height=intr.height, near=near, far=far,
                timestamp=float(j - cfg.start_timestamp),
            ))
    infos.sort(key=lambda c: c.image_name)
    train = [c for c in infos if "cam00" not in c.image_path]
    test = [c for c in infos if "cam00" in c.image_path]
    if {c.image_path for c in test} & {c.image_path for c in train}:
        raise ValueError(f"{path}: a frame is in both the train and the test split")
    norm = nerfpp_norm(train)
    pc, ply_path = _load_points(os.path.join(colmap_path, "sparse", "0"))
    return SceneInfo(pc, train, test, norm, ply_path)


def read_technicolor_scene(path: str, cfg) -> SceneInfo:
    """Technicolor light-field scene (dataset_readers.py:444-517)."""
    colmap_path = os.path.join(path, f"colmap_{int(cfg.start_timestamp)}")
    cams, imgs = read_model(os.path.join(colmap_path, "sparse", "0"))
    near, far = 0.01, 100.0

    img_paths = sorted(glob.glob(path + "/*.png"))
    img_dict: dict[int, list] = {}
    for p in img_paths:
        matches = re.findall("[0-9]+", p)
        ts, cam_id = int(matches[-2]), int(matches[-1])
        img_dict.setdefault(cam_id, []).append((p, ts))

    infos = []
    for key in imgs:
        extr = imgs[key]
        intr = cams[extr.camera_id]
        fovx, fovy, fx, fy = _intrinsics_to_fov(intr)
        R = qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        cam_id = int(extr.name[3:5])
        cxr = intr.params[2] / intr.width - 0.5
        cyr = intr.params[3] / intr.height - 0.5
        for image_path, ts in img_dict.get(cam_id, []):
            if ts < cfg.start_timestamp or (
                cfg.end_timestamp != -1 and ts >= cfg.end_timestamp
            ):
                continue
            infos.append(CameraInfo(
                uid=intr.id, R=R, T=T, fovx=fovx, fovy=fovy,
                image_path=image_path, image_name=os.path.basename(image_path),
                width=intr.width, height=intr.height, near=near, far=far,
                timestamp=float(ts - cfg.start_timestamp), cxr=cxr, cyr=cyr,
            ))
    infos.sort(key=lambda c: c.image_name)
    if cfg.eval:
        train = [c for c in infos if "_10.png" not in c.image_name]
        test = [c for c in infos if "_10.png" in c.image_name]
        if len({c.uid for c in test}) != 1 or {c.uid for c in test} & {c.uid for c in train}:
            raise ValueError(f"{path}: the test split must be exactly one camera, "
                             "not in the train split")
    else:
        train, test = infos, infos[:4]

    norm = nerfpp_norm(train)
    radius = norm["radius"]
    # normalize camera translations + init points by the scene radius, then
    # treat the scene as unit-scale (dataset_readers.py:487-509)
    train_ids = {id(c) for c in train}
    for c in train:
        c.T = c.T / radius
    for c in test:
        if id(c) not in train_ids:  # identity: don't double-normalize shares
            c.T = c.T / radius
    pc, ply_path = _load_points(
        os.path.join(colmap_path, "sparse", "0"), transform=lambda x: x / radius
    )
    norm["radius"] = 1
    return SceneInfo(pc, train, test, norm, ply_path)


def read_colmap_scene(path: str, cfg) -> SceneInfo:
    """Generic static COLMAP scene with llffhold split (dataset_readers.py:352-398)."""
    sparse = os.path.join(path, "sparse", "0")
    cams, imgs = read_model(sparse)
    reading_dir = cfg.images or "images"

    infos = []
    for key in imgs:
        extr = imgs[key]
        intr = cams[extr.camera_id]
        fovx, fovy, _, _ = _intrinsics_to_fov(intr)
        infos.append(CameraInfo(
            uid=intr.id,
            R=qvec2rotmat(extr.qvec).T,
            T=np.array(extr.tvec),
            fovx=fovx, fovy=fovy,
            image_path=os.path.join(path, reading_dir, os.path.basename(extr.name)),
            image_name=os.path.basename(extr.name).split(".")[0],
            width=intr.width, height=intr.height,
            near=cfg.near, far=cfg.far, timestamp=0.0,
        ))
    infos.sort(key=lambda c: c.image_name)
    if cfg.eval:
        train = [c for i, c in enumerate(infos) if i % cfg.llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % cfg.llffhold == 0]
    else:
        train, test = infos, []
    norm = nerfpp_norm(train)
    pc, ply_path = _load_points(sparse)
    return SceneInfo(pc, train, test, norm, ply_path)


SCENE_READERS: dict[str, Callable] = {
    "neural3dvideo": read_n3v_scene,
    "technicolor": read_technicolor_scene,
    "technicolorvalid": read_technicolor_scene,
    "colmap": read_colmap_scene,
    "colmapvalid": read_colmap_scene,
}
