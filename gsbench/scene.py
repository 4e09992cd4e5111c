"""Seeded scenes, rigs and cameras of the benchmark's configurations.

Everything here is the benchmark's own: the program receives only what
these functions make. A scene is a dict of float32 parameter tensors in
the program's layout (capacity-padded static and dynamic splats, the
names of `ex4dgs_tpu_torch.models.state`), drawn on the device from one
`torch.Generator` in a few large calls, so the same seed gives the same
scene on the same device. Cameras are host matrices (the numbers a viewer
client sends); the program builds its cameras from them as its viewer
does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def _round_up(n: int, granularity: int) -> int:
    return max(granularity, -(-int(n) // granularity) * granularity)


def capacities(cfg: dict) -> tuple[int, int]:
    """(static, dynamic) row capacities as the trainer holds them: rounded
    up to 4096 and 1024 rows."""
    return _round_up(cfg["n_static"], 4096), _round_up(cfg["n_dynamic"], 1024)


def time_shift(cfg: dict) -> int:
    """time_pad, plus one interval for the four-point interpolators."""
    if cfg["interp_type"] in ("cube", "pchip"):
        return cfg["time_pad"] + cfg["time_interval"]
    return cfg["time_pad"]


def keyframes(cfg: dict) -> int:
    """Keyframes for the whole duration, as the trainer sizes them
    (`required_keyframes(duration + time_shift)`)."""
    shift = time_shift(cfg)
    dur = cfg["frames"] + shift
    return math.ceil((dur + shift + cfg["time_pad"] * 2 + 1) / cfg["time_interval"]) + 3


def make_params(cfg: dict, seed: int, device, perturb: dict | None = None) -> dict:
    """The scene's parameters and masks (float32 on `device`) from `seed`.

    Static splats: a Gaussian cloud of std `cloud_std` around the origin,
    log-uniform sizes in `splat_size`, random unit quaternions, colours
    (DC) uniform in [0.05, 0.95], higher SH bands N(0, `sh_std`), opacities
    uniform in `opacity`, a small per-splat displacement over the duration.
    Dynamic splats: the same, moving on smooth per-keyframe orbits, with
    slowly turning rotations and a seeded visibility window. `perturb`
    (colour and opacity standard deviations) adds seeded noise to colours
    and opacities only, from a second stream of the same seed: the target
    the training cell fits."""
    dev = torch.device(device)
    ps, pd = capacities(cfg)
    ns, nd = cfg["n_static"], cfg["n_dynamic"]
    k = keyframes(cfg)
    n_rest = (cfg["sh_degree"] + 1) ** 2 - 1
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, **f32)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    std = cfg["cloud_std"]
    lo_s, hi_s = (math.log(v) for v in cfg["splat_size"])
    op_lo, op_hi = cfg["opacity"]

    def logit(p):
        return torch.log(p / (1.0 - p))

    def quats(*shape):
        q = normal(*shape, 4)
        return q / torch.linalg.norm(q, dim=-1, keepdim=True)

    p = {}
    p["xyz"] = normal(ps, 3) * std
    p["f_dc"] = ((uniform(0.05, 0.95, ps, 1, 3)) - 0.5) / SH_C0
    p["f_rest"] = normal(ps, n_rest, 3) * cfg["sh_std"]
    p["opacity"] = logit(uniform(op_lo, op_hi, ps, 1))
    p["scaling"] = uniform(lo_s, hi_s, ps, 3)
    p["rotation"] = quats(ps)
    p["xyz_disp"] = normal(ps, 3) * cfg["disp_std"]

    # Dynamic splats: centre + an orbit of radius `orbit` turning `turn`
    # radians per keyframe, in a seeded plane.
    centre = normal(pd, 1, 3) * std
    phase = uniform(0.0, 2 * math.pi, pd, 1, 1)
    axis_a = normal(pd, 1, 3)
    axis_a = axis_a / torch.linalg.norm(axis_a, dim=-1, keepdim=True)
    axis_b = normal(pd, 1, 3)
    axis_b = axis_b - (axis_b * axis_a).sum(-1, keepdim=True) * axis_a
    axis_b = axis_b / torch.linalg.norm(axis_b, dim=-1, keepdim=True)
    ang = phase + cfg["turn"] * torch.arange(k, **f32).view(1, k, 1)
    p["motion_xyz"] = centre + cfg["orbit"] * (torch.cos(ang) * axis_a + torch.sin(ang) * axis_b)
    p["motion_f_dc"] = ((uniform(0.05, 0.95, pd, 1, 3)) - 0.5) / SH_C0
    p["motion_f_rest"] = normal(pd, n_rest, 3) * cfg["sh_std"]
    p["motion_scaling"] = uniform(lo_s, hi_s, pd, 3)
    p["motion_opacity"] = logit(uniform(op_lo, op_hi, pd, 1))
    # Visible over a seeded window of the duration, in keyframe units
    # u = (t + time_shift) / time_interval, fading over ~one interval.
    u0 = time_shift(cfg) / cfg["time_interval"]
    span = cfg["frames"] / cfg["time_interval"]
    length = uniform(0.25, 1.0, pd) * span
    start = u0 + uniform(0.0, 1.0, pd) * (span - length)
    p["motion_opacity_center"] = torch.stack([start, start + length], dim=-1)
    p["motion_opacity_var"] = uniform(-1.0, 0.5, pd, 2)
    base = quats(pd, 1)
    drift = normal(pd, k, 4) * cfg["rot_drift"]
    rot = base + torch.cumsum(drift, dim=1)
    p["motion_rotation"] = rot / torch.linalg.norm(rot, dim=-1, keepdim=True)

    if perturb:
        pg = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x5EED5EED)
        for key, sd in (("f_dc", perturb["color_std"]), ("motion_f_dc", perturb["color_std"]),
                        ("opacity", perturb["opacity_std"]),
                        ("motion_opacity", perturb["opacity_std"])):
            p[key] = p[key] + sd * torch.randn(p[key].shape, generator=pg, **f32)

    # Capacity padding: inactive rows hold the program's empty values.
    static_mask = torch.arange(ps, device=dev) < ns
    dynamic_mask = torch.arange(pd, device=dev) < nd
    for key, v in p.items():
        mask = dynamic_mask if key.startswith("motion_") else static_mask
        mb = mask.view(-1, *([1] * (v.ndim - 1)))
        p[key] = torch.where(mb, v, _empty_row(key, v))
    return {"params": p, "static_mask": static_mask, "dynamic_mask": dynamic_mask,
            "keyframe_num": k, "duration": float(cfg["frames"]), "active_sh_degree":
            cfg["sh_degree"]}


def _empty_row(key: str, v: torch.Tensor) -> torch.Tensor:
    """The value of an inactive capacity row (ex4dgs_tpu_torch's empty
    model: identity rotations, log-scale and logit -10, zeros)."""
    if key in ("opacity", "scaling", "motion_scaling", "motion_opacity"):
        return torch.full_like(v, -10.0)
    if key in ("rotation", "motion_rotation"):
        e = torch.zeros_like(v)
        e[..., 0] = 1.0
        return e
    return torch.zeros_like(v)


# ---------------------------------------------------------------------------
# Cameras: host matrices, as a client sends them
# ---------------------------------------------------------------------------

def lookat(eye, target, width: int, height: int, fov_x_deg: float, near: float,
           far: float) -> dict:
    """A pinhole camera at `eye` looking at `target` (+z forward, y down):
    world->camera `view`, full projection `proj` = P @ view, `campos`, and
    the field of view (fovy from the aspect ratio, square pixels)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd], axis=1)  # camera-to-world
    view = np.eye(4)
    view[:3, :3] = rot.T
    view[:3, 3] = -rot.T @ eye
    fovx = math.radians(fov_x_deg)
    tan_x = math.tan(fovx / 2)
    tan_y = tan_x * height / width
    fovy = 2 * math.atan(tan_y)
    P = np.zeros((4, 4))
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[3, 2] = 1.0
    P[2, 2] = far / (far - near)
    P[2, 3] = -(far * near) / (far - near)
    return {"view": view.astype(np.float32), "proj": (P @ view).astype(np.float32),
            "campos": eye.astype(np.float32), "width": width, "height": height,
            "fovx": fovx, "fovy": fovy}


def rig_positions(rig: dict) -> np.ndarray:
    """[n, 3] camera centres of a rig: `arc` (cameras on a horizontal arc
    of `span_deg` at `distance` from the target, alternating between two
    heights) or `grid` (a rows x cols planar array of `spacing` at
    `distance`, less the cameras in `held_out`)."""
    d = rig["distance"]
    if rig["kind"] == "arc":
        n = rig["cameras"]
        out = []
        for i in range(n):
            a = math.radians(rig["span_deg"]) * (i / max(n - 1, 1) - 0.5)
            h = rig["heights"][i % len(rig["heights"])]
            out.append((d * math.sin(a), h, -d * math.cos(a)))
        return np.asarray(out, np.float64)
    if rig["kind"] == "grid":
        out = []
        for r in range(rig["rows"]):
            for c in range(rig["cols"]):
                if r * rig["cols"] + c in rig["held_out"]:
                    continue
                out.append(((c - (rig["cols"] - 1) / 2) * rig["spacing"],
                            (r - (rig["rows"] - 1) / 2) * rig["spacing"], -d))
        return np.asarray(out, np.float64)
    raise ValueError(f"unknown rig kind {rig['kind']!r}")


def rig_cameras(cfg: dict) -> list[dict]:
    """The configuration's training cameras (host matrices)."""
    return [lookat(e, (0.0, 0.0, 0.0), cfg["width"], cfg["height"], cfg["fov_x_deg"],
                   cfg["near"], cfg["far"]) for e in rig_positions(cfg["rig"])]


def cameras_extent(cfg: dict) -> float:
    """The trainer's spatial learning-rate scale: 1.1 x the largest distance
    of a camera centre from the centres' mean."""
    c = rig_positions(cfg["rig"])
    return float(np.linalg.norm(c - c.mean(0), axis=1).max() * 1.1)


def path_cameras(cfg: dict, n: int, seed: int) -> list[dict]:
    """n viewer cameras on one closed loop through the rig's extent (an
    ellipse over the rig's positions, at the rig's distance), starting at a
    seeded phase and running in a seeded direction: every seed sees the
    same views, in another order."""
    c = rig_positions(cfg["rig"])
    centre = c.mean(0)
    half = np.maximum((c.max(0) - c.min(0)) / 2, 1e-3)
    rng = np.random.default_rng(int(seed))
    phase = rng.uniform(0, 2 * math.pi)
    direction = 1.0 if rng.uniform() < 0.5 else -1.0
    out = []
    for i in range(n):
        a = phase + direction * 2 * math.pi * i / n
        eye = centre.copy()
        eye[0] += half[0] * math.cos(a)
        eye[1] += max(half[1], 0.05 * cfg["rig"]["distance"]) * math.sin(a)
        out.append(lookat(eye, (0.0, 0.0, 0.0), cfg["width"], cfg["height"],
                          cfg["fov_x_deg"], cfg["near"], cfg["far"]))
    return out
