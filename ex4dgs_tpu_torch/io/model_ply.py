"""Splat-model PLY export/import — byte-compatible with the reference format.

Static cloud (point_cloud.ply): x y z nx ny nz f_dc_{0..2}
f_rest_{0..3*(K-1)-1} opacity scale_{0..2} rot_{0..3} xyz_disp_{0..2}
(c_gaussian_model.py:473-531; f_dc/f_rest are flattened channel-major, i.e.
transpose(1,2) of our [P, K, 3] layout).

Dynamic cloud (dynamic_point_cloud.ply): motion_xyz_{k}_{d},
motion_f_dc/rest, motion_scale, motion_opacity, motion_opacity_c/v_{0,1},
motion_rot_{k}_{d} (:490-547). This lets trained reference checkpoints load
into this framework (and vice versa) for cross-validation.

Counterpart of `ex4dgs_tpu/io/model_ply.py` (the same code on the port's
HostModel), so either package reads the other's files.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.density import HostModel
from ..models.state import _init_stats
from .ply import read_ply, write_ply


def save_model_ply(hm: HostModel, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    p = hm.params
    n = hm.n_static
    cols: dict[str, np.ndarray] = {}
    xyz = p["xyz"]
    for i, ax in enumerate("xyz"):
        cols[ax] = xyz[:, i]
    for ax in ("nx", "ny", "nz"):
        cols[ax] = np.zeros(n, np.float32)
    # [P, 1, 3] -> channel-major flatten (transpose(1,2).flatten)
    f_dc = p["f_dc"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_dc.shape[1]):
        cols[f"f_dc_{i}"] = f_dc[:, i]
    f_rest = p["f_rest"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_rest.shape[1]):
        cols[f"f_rest_{i}"] = f_rest[:, i]
    cols["opacity"] = p["opacity"][:, 0]
    for i in range(3):
        cols[f"scale_{i}"] = p["scaling"][:, i]
    for i in range(4):
        cols[f"rot_{i}"] = p["rotation"][:, i]
    for i in range(3):
        cols[f"xyz_disp_{i}"] = p["xyz_disp"][:, i]
    write_ply(path, cols)

    # dynamic cloud
    nd = hm.n_dynamic
    kf = p["motion_xyz"].shape[1]
    dcols: dict[str, np.ndarray] = {}
    mx = p["motion_xyz"].reshape(nd, kf * 3)
    idx = 0
    for k in range(kf):
        for d in range(3):
            dcols[f"motion_xyz_{k}_{d}"] = mx[:, idx]
            idx += 1
    mdc = p["motion_f_dc"].transpose(0, 2, 1).reshape(nd, 3)
    for i in range(mdc.shape[1]):
        dcols[f"motion_f_dc_{i}"] = mdc[:, i]
    mre = p["motion_f_rest"].transpose(0, 2, 1).reshape(nd, p["motion_f_rest"].shape[1] * 3)
    for i in range(mre.shape[1]):
        dcols[f"motion_f_rest_{i}"] = mre[:, i]
    for i in range(3):
        dcols[f"motion_scale_{i}"] = p["motion_scaling"][:, i]
    dcols["motion_opacity"] = p["motion_opacity"][:, 0]
    for i in range(2):
        dcols[f"motion_opacity_c_{i}"] = p["motion_opacity_center"][:, i]
    for i in range(2):
        dcols[f"motion_opacity_v_{i}"] = p["motion_opacity_var"][:, i]
    mr = p["motion_rotation"].reshape(nd, kf * 4)
    idx = 0
    for k in range(kf):
        for d in range(4):
            dcols[f"motion_rot_{k}_{d}"] = mr[:, idx]
            idx += 1
    if "motion_xyz_d" in p:
        # extension columns (cubic_diff tangents) — absent in reference PLYs
        md = p["motion_xyz_d"].reshape(nd, kf * 3)
        idx = 0
        for k in range(kf):
            for d in range(3):
                dcols[f"motion_xyz_d_{k}_{d}"] = md[:, idx]
                idx += 1
    write_ply(path.replace("point_cloud.ply", "dynamic_point_cloud.ply"), dcols)


def load_model_ply(path: str, cfg: ModelConfig, duration: float) -> HostModel:
    """Load the (static, dynamic) PLY pair into a compact HostModel
    (c_gaussian_model.py:560-670). Optimizer state starts fresh."""
    v = read_ply(path)
    n = len(v)
    sh_rest = 3 * (cfg.sh_degree + 1) ** 2 - 3

    def grab(prefix, count):
        return np.stack([v[f"{prefix}_{i}"] for i in range(count)], axis=1)

    params = {
        "xyz": np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32),
        "f_dc": grab("f_dc", 3).reshape(n, 3, 1).transpose(0, 2, 1).astype(np.float32),
        "f_rest": grab("f_rest", sh_rest).reshape(n, 3, sh_rest // 3)
        .transpose(0, 2, 1).astype(np.float32),
        "opacity": np.asarray(v["opacity"], np.float32).reshape(n, 1),
        "scaling": grab("scale", 3).astype(np.float32),
        "rotation": grab("rot", 4).astype(np.float32),
        "xyz_disp": grab("xyz_disp", 3).astype(np.float32),
    }

    dpath = path.replace("point_cloud.ply", "dynamic_point_cloud.ply")
    time_shift = cfg.time_shift
    keyframe_num = (
        math.ceil((duration + time_shift + cfg.time_pad * 2 + 1) / cfg.time_interval)
        + 1 + 4
    )
    if os.path.exists(dpath):
        dv = read_ply(dpath)
        nd = len(dv)
        kf_cols = [c for c in dv.dtype.names if c.startswith("motion_xyz_")]
        keyframe_num = max(int(c.split("_")[-2]) for c in kf_cols) + 1 if kf_cols else 0

        def dgrab2(prefix, k, d):
            out = np.zeros((nd, k, d), np.float32)
            for i in range(k):
                for j in range(d):
                    out[:, i, j] = dv[f"{prefix}_{i}_{j}"]
            return out

        def dgrab(prefix, count):
            return np.stack([dv[f"{prefix}_{i}"] for i in range(count)], 1)

        params.update({
            "motion_xyz": dgrab2("motion_xyz", keyframe_num, 3),
            "motion_f_dc": dgrab("motion_f_dc", 3).reshape(nd, 3, 1)
            .transpose(0, 2, 1).astype(np.float32),
            "motion_f_rest": dgrab("motion_f_rest", sh_rest)
            .reshape(nd, 3, sh_rest // 3).transpose(0, 2, 1).astype(np.float32),
            "motion_scaling": dgrab("motion_scale", 3).astype(np.float32),
            "motion_opacity": np.asarray(dv["motion_opacity"], np.float32).reshape(nd, 1),
            "motion_opacity_center": dgrab("motion_opacity_c", 2).astype(np.float32),
            "motion_opacity_var": dgrab("motion_opacity_v", 2).astype(np.float32),
            "motion_rotation": dgrab2("motion_rot", keyframe_num, 4),
        })
        if any(c.startswith("motion_xyz_d_") for c in dv.dtype.names):
            params["motion_xyz_d"] = dgrab2("motion_xyz_d", keyframe_num, 3)
    else:
        nd = 0
        params.update({
            "motion_xyz": np.zeros((0, 0, 3), np.float32),
            "motion_f_dc": np.zeros((0, 1, 3), np.float32),
            "motion_f_rest": np.zeros((0, sh_rest // 3, 3), np.float32),
            "motion_scaling": np.zeros((0, 3), np.float32),
            "motion_opacity": np.zeros((0, 1), np.float32),
            "motion_opacity_center": np.zeros((0, 2), np.float32),
            "motion_opacity_var": np.zeros((0, 2), np.float32),
            "motion_rotation": np.zeros((0, 0, 4), np.float32),
        })

    stats = {k: s.numpy() for k, s in _init_stats(n, nd, torch.device("cpu")).items()}
    mu = {k: np.zeros_like(p) for k, p in params.items()}
    nu = {k: np.zeros_like(p) for k, p in params.items()}
    return HostModel(
        params=params, stats=stats, mu=mu, nu=nu, step=0,
        active_sh_degree=cfg.sh_degree, duration=float(duration),
        keyframe_num=keyframe_num,
    )
