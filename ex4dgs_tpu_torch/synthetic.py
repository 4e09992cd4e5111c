"""Synthetic scenes and cameras.

Counterpart of `ex4dgs_tpu/synthetic.py` (`lookat_camera`, `ring_cameras`,
`rig_cameras`, `make_scene`, `make_surface_scene`): the same numpy draws in
the same order from the same seed, so both packages build the same scene.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import resolve_device
from .models.config import ModelConfig
from .models.state import GaussianModel, create_from_pcd
from .ops.math3d import inverse_sigmoid, projection_matrix, rgb_to_sh0, world_to_view
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
    return rig_cameras(n, radius, width, height, target, elevs=(elev,), device=device, **kw)


def rig_cameras(n, radius, width, height, target=(0, 0, 0), elevs=(0.2, 0.5), device=None,
                **kw) -> list[RenderCamera]:
    """An N3V-like capture rig: n cameras around a ring, alternating between
    two elevations (a single coplanar ring leaves view-direction space, and
    so SH fitting, badly conditioned)."""
    dev = resolve_device(device)
    cams = []
    for i in range(n):
        a = 2 * math.pi * i / max(n, 1)
        e = elevs[i % len(elevs)]
        eye = (radius * math.cos(a), e * radius, radius * math.sin(a))
        cams.append(lookat_camera(eye, target, (0, 1, 0), width, height, device=dev, **kw))
    return cams


def _activate_dynamic(model: GaussianModel, cfg: ModelConfig, n_dynamic: int,
                      duration: float) -> None:
    """The first n_dynamic dynamic rows become active and visible over the
    whole duration, with every keyframe active."""
    p = model.params
    shift_u = cfg.time_shift / cfg.time_interval
    p["motion_opacity_center"][:n_dynamic, 0] = shift_u
    p["motion_opacity_center"][:n_dynamic, 1] = shift_u + duration / cfg.time_interval
    p["motion_opacity_var"][:n_dynamic] = 1.0
    model.dynamic_mask[:n_dynamic] = True
    model.keyframe_num = torch.tensor(model.keyframe_capacity, dtype=torch.int32,
                                      device=model.device)


def _smooth_color(p: np.ndarray, freqs: np.ndarray, phases: np.ndarray) -> np.ndarray:
    """Low-frequency procedural colour field in [0.08, 0.92]: a few sinusoids
    of the 3-D position per channel."""
    c = np.stack([
        np.sin(p @ freqs[3 * k] + phases[3 * k])
        + 0.5 * np.sin(p @ freqs[3 * k + 1] + phases[3 * k + 1])
        + 0.25 * np.sin(p @ freqs[3 * k + 2] + phases[3 * k + 2])
        for k in range(3)
    ], axis=-1)  # in [-1.75, 1.75]
    return (0.5 + c / 4.2).astype(np.float32)


def make_surface_scene(n_static: int = 50_000, n_dynamic: int = 5_000, duration: float = 8.0,
                       seed: int = 0, cfg: ModelConfig | None = None,
                       static_capacity: int | None = None,
                       dynamic_capacity: int | None = None,
                       device=None) -> tuple[GaussianModel, ModelConfig]:
    """A reconstructable synthetic capture: a textured ground plane and
    static spheres (points on 2-D surfaces, smooth colour fields,
    near-opaque splats sized to the surface sampling density), plus small
    rigidly moving dynamic spheres on closed paths."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = ModelConfig(time_interval=5, start_duration=5, duration=int(duration),
                          near=0.2, far=100.0)
    rng = np.random.default_rng(seed)

    n_plane = n_static // 2
    n_blob = n_static - n_plane
    # ground plane y=-0.9, extent +-1.7
    pp = np.empty((n_plane, 3), np.float32)
    pp[:, 0] = rng.uniform(-1.7, 1.7, n_plane)
    pp[:, 2] = rng.uniform(-1.7, 1.7, n_plane)
    pp[:, 1] = -0.9
    plane_spacing = math.sqrt(3.4 * 3.4 / max(n_plane, 1))

    # static spheres above the plane
    K = 6
    centers = np.stack([
        rng.uniform(-1.1, 1.1, K),
        rng.uniform(-0.5, 0.35, K),
        rng.uniform(-1.1, 1.1, K),
    ], axis=1).astype(np.float32)
    radii = rng.uniform(0.25, 0.5, K).astype(np.float32)
    counts = np.full(K, n_blob // K)
    counts[: n_blob % K] += 1
    bp, bsp = [], []
    for k in range(K):
        d = rng.normal(size=(counts[k], 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
        bp.append(centers[k] + radii[k] * d)
        bsp.append(np.full(counts[k],
                           math.sqrt(4 * math.pi * radii[k] ** 2 / max(counts[k], 1))))
    pts = np.concatenate([pp] + bp).astype(np.float32)
    spacing = np.concatenate([np.full(n_plane, plane_spacing)] + bsp).astype(np.float32)

    freqs = rng.uniform(-4.0, 4.0, size=(9, 3))
    phases = rng.uniform(0, 2 * np.pi, size=9)
    cols = _smooth_color(pts, freqs, phases)

    sc = static_capacity or max(1, n_static)
    dc = dynamic_capacity if dynamic_capacity is not None else n_dynamic
    model = create_from_pcd(pts, cols, cfg, duration=duration, static_capacity=sc,
                            dynamic_capacity=dc, device=dev)
    opaque = float(inverse_sigmoid(torch.tensor(np.float32(0.95))))
    p = model.params
    log_scale = np.log(np.clip(0.7 * spacing, 1e-4, 0.05))[:, None]
    p["scaling"][:n_static] = torch.as_tensor(np.repeat(log_scale, 3, axis=1), device=dev)
    p["opacity"][:n_static] = opaque

    if n_dynamic > 0:
        kf = model.keyframe_capacity
        # a few small spheres on rigid closed paths (smooth keyframe motion)
        D = 3
        dcounts = np.full(D, n_dynamic // D)
        dcounts[: n_dynamic % D] += 1
        ts = np.arange(kf, dtype=np.float32)
        dyn_pts, dyn_traj, dyn_spacing = [], [], []
        for k in range(D):
            r = 0.18
            d = rng.normal(size=(dcounts[k], 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
            base = (r * d).astype(np.float32)  # body frame
            c0 = np.array([rng.uniform(-0.8, 0.8), rng.uniform(-0.3, 0.3),
                           rng.uniform(-0.8, 0.8)], np.float32)
            ax = rng.uniform(0, 2 * np.pi)
            # circular arc path, ~0.6 world units over the duration
            w = 0.25 + 0.1 * k
            path = 0.45 * np.stack([
                np.cos(w * ts + ax), 0.3 * np.sin(2 * w * ts + ax),
                np.sin(w * ts + ax),
            ], axis=1).astype(np.float32)  # [kf, 3]
            dyn_pts.append(c0 + base)
            dyn_traj.append(c0[None, None] + path[None] + base[:, None])
            dyn_spacing.append(np.full(
                dcounts[k], math.sqrt(4 * math.pi * r * r / max(dcounts[k], 1))))
        dyn_pts = np.concatenate(dyn_pts).astype(np.float32)
        traj = np.concatenate(dyn_traj).astype(np.float32)  # [n_dyn, kf, 3]
        dspacing = np.concatenate(dyn_spacing).astype(np.float32)
        dcols = _smooth_color(dyn_pts * 1.7, freqs, phases)

        p["motion_xyz"][:n_dynamic] = torch.as_tensor(traj, device=dev)
        p["motion_f_dc"][:n_dynamic, 0] = rgb_to_sh0(torch.as_tensor(dcols, device=dev))
        p["motion_scaling"][:n_dynamic] = torch.as_tensor(np.repeat(
            np.log(np.clip(0.7 * dspacing, 1e-4, 0.05))[:, None], 3, axis=1), device=dev)
        p["motion_opacity"][:n_dynamic] = opaque
        _activate_dynamic(model, cfg, n_dynamic, duration)
    return model, cfg


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
        _activate_dynamic(model, cfg, n_dynamic, duration)
    return model, cfg
