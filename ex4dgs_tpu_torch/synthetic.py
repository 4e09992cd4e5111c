"""Synthetic scenes and cameras.

Counterpart of `ex4dgs_tpu/synthetic.py` (`lookat_camera`, `ring_cameras`,
`make_scene`): the same numpy draws in the same order from the same seed,
so both packages build the same scene.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import resolve_device
from .models.config import ModelConfig
from .models.state import GaussianModel, create_from_pcd
from .ops.math3d import inverse_sigmoid, projection_matrix, world_to_view
from .rendering import RenderCamera


def lookat_camera(eye, target, up, width, height, fov_deg=60.0, near=0.2, far=100.0,
                  device=None) -> RenderCamera:
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    # camera-to-world rotation with +z forward (COLMAP convention)
    R = np.stack([right, down, fwd], axis=1)
    t = -R.T @ eye
    view = world_to_view(R, t)
    fov = math.radians(fov_deg)
    P = projection_matrix(near, far, fov, fov)
    return RenderCamera.from_fov(view, P @ view, eye, width, height, fov, fov, device=device)


def ring_cameras(n, radius, width, height, target=(0, 0, 0), elev=0.35, device=None,
                 **kw) -> list[RenderCamera]:
    dev = resolve_device(device)
    cams = []
    for i in range(n):
        a = 2 * math.pi * i / max(n, 1)
        eye = (radius * math.cos(a), elev * radius, radius * math.sin(a))
        cams.append(lookat_camera(eye, target, (0, 1, 0), width, height, device=dev, **kw))
    return cams


def make_scene(n_static: int = 20000, n_dynamic: int = 2000, duration: float = 10.0,
               seed: int = 0, cfg: ModelConfig | None = None,
               static_capacity: int | None = None, dynamic_capacity: int | None = None,
               opacity: float | None = None,
               device=None) -> tuple[GaussianModel, ModelConfig]:
    """A unit-box cloud of static splats plus orbiting dynamic splats.

    opacity: optional static-splat opacity override (default keeps
    create_from_pcd's 0.1)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = ModelConfig(time_interval=5, start_duration=5, duration=int(duration),
                          near=0.2, far=100.0)
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_static, 3)).astype(np.float32) * 0.7
    cols = rng.uniform(0.05, 0.95, size=(n_static, 3)).astype(np.float32)
    sc = static_capacity or max(1, n_static)
    dc = dynamic_capacity if dynamic_capacity is not None else n_dynamic
    model = create_from_pcd(pts, cols, cfg, duration=duration, static_capacity=sc,
                            dynamic_capacity=dc, device=dev)
    p = model.params
    # Clip the far tail of the volumetric cloud's KNN scales, so the splat
    # sizes resemble a trained scene's.
    p["scaling"] = torch.clamp_max(p["scaling"], math.log(0.03))
    if opacity is not None:
        p["opacity"][:n_static] = float(inverse_sigmoid(torch.tensor(opacity)))

    if n_dynamic > 0:
        kf = model.keyframe_capacity
        centers = rng.normal(size=(n_dynamic, 1, 3)).astype(np.float32) * 0.6
        phase = rng.uniform(0, 2 * np.pi, size=(n_dynamic, 1, 1)).astype(np.float32)
        ts = np.arange(kf, dtype=np.float32).reshape(1, kf, 1)
        cosv = np.cos(0.3 * ts + phase)
        orbit = 0.25 * np.concatenate(
            [cosv, np.sin(0.3 * ts + phase), np.zeros_like(cosv)], axis=-1
        ).astype(np.float32)
        p["motion_xyz"][:n_dynamic] = torch.as_tensor(centers + orbit, device=dev)
        p["motion_f_dc"][:n_dynamic, 0] = torch.as_tensor(
            rng.uniform(-1, 1, size=(n_dynamic, 3)).astype(np.float32), device=dev)
        p["motion_scaling"][:n_dynamic] = -4.0
        p["motion_opacity"][:n_dynamic] = 1.0
        shift_u = cfg.time_shift / cfg.time_interval
        p["motion_opacity_center"][:n_dynamic, 0] = shift_u
        p["motion_opacity_center"][:n_dynamic, 1] = shift_u + duration / cfg.time_interval
        p["motion_opacity_var"][:n_dynamic] = 1.0
        model.dynamic_mask[:n_dynamic] = True
        model.keyframe_num = torch.tensor(kf, dtype=torch.int32, device=dev)
    return model, cfg
