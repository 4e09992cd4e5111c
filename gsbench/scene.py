"""Seeded scenes, rigs and cameras of the benchmark's configurations.

Everything here is the benchmark's own: the program receives only what
these functions make. A scene is drawn by the configuration's model family
(`families/<family>.py`) on the device from the seed, so the same seed
gives the same scene on the same device. Rigs and cameras are shared by
every family: cameras are host matrices (the numbers a viewer client
sends); the program builds its cameras from them as its viewer does.
"""
from __future__ import annotations

import math

import numpy as np

from .families import load


def make_params(cfg: dict, seed: int, device, perturb: dict | None = None) -> dict:
    """The scene of the configuration's family (`families/<family>.py`'s
    `make_params`) from `seed`, on `device`."""
    return load(cfg).make_params(cfg, seed, device, perturb=perturb)


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
