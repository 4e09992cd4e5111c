"""Gaussian model state: capacity-padded static + dynamic splats.

Counterpart of `ex4dgs_tpu/models/state.py`. Every array is padded to a
capacity with an explicit active mask, and the param, mask and stat names
and shapes are the JAX package's, so a model moves between the two packages
name for name (`model_from_numpy` / `model_to_numpy`) and tests compare
row for row.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import resolve_device
from ..ops.knn import mean_knn_dist2
from ..ops.math3d import inverse_sigmoid, rgb_to_sh0
from .config import ModelConfig

STATIC_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "xyz_disp")
DYNAMIC_KEYS = (
    "motion_xyz",
    "motion_f_dc",
    "motion_f_rest",
    "motion_scaling",
    "motion_opacity",
    "motion_opacity_center",
    "motion_opacity_var",
    "motion_rotation",
)
# Parameters with a keyframe axis [P, K, ...]; "motion_xyz_d" (Hermite
# tangents) exists only when the config selects interp_type="cubic_diff".
KEYFRAME_KEYS = ("motion_xyz", "motion_rotation", "motion_xyz_d")
STATIC_STAT_KEYS = (
    "max_radii2D",
    "min_radii2D",
    "xyz_gradient_accum",
    "denom",
    "xyz_error_accum",
    "xyz_error_min",
    "xyz_error_min_timestamp",
    "xyz_ssim_error_accum",
    "error_denom",
)
DYNAMIC_STAT_KEYS = (
    "motion_max_radii2D",
    "motion_min_radii2D",
    "motion_xyz_gradient_accum",
    "motion_denom",
    "motion_xyz_error_min",
    "motion_xyz_error_mean",
    "motion_xyz_error_min_timestamp",
    "motion_xyz_ssim_error_accum",
    "motion_error_denom",
)

CAPACITY_GRANULARITY = 4096


@dataclasses.dataclass
class GaussianModel:
    """All model state on one device. Static rows have leading dim Ps,
    dynamic rows Pd; the scalars are 0-d tensors."""

    params: dict  # name -> tensor, see STATIC_KEYS / DYNAMIC_KEYS
    static_mask: torch.Tensor  # [Ps] bool, active static splats
    dynamic_mask: torch.Tensor  # [Pd] bool
    stats: dict  # name -> [Ps] or [Pd] float32 accumulators
    active_sh_degree: torch.Tensor  # [] int32
    duration: torch.Tensor  # [] float32
    keyframe_num: torch.Tensor  # [] int32, active keyframes (<= K capacity)

    @property
    def static_capacity(self) -> int:
        return self.params["xyz"].shape[0]

    @property
    def dynamic_capacity(self) -> int:
        return self.params["motion_xyz"].shape[0]

    @property
    def keyframe_capacity(self) -> int:
        return self.params["motion_xyz"].shape[1]

    @property
    def device(self) -> torch.device:
        return self.params["xyz"].device

    def n_static(self) -> torch.Tensor:
        """Active static splats, a 0-d tensor on the model's device."""
        return self.static_mask.sum()

    def n_dynamic(self) -> torch.Tensor:
        """Active dynamic splats, a 0-d tensor on the model's device."""
        return self.dynamic_mask.sum()

    def replace(self, **changes) -> "GaussianModel":
        return dataclasses.replace(self, **changes)


def round_capacity(n: int, granularity: int = CAPACITY_GRANULARITY) -> int:
    return max(granularity, ((int(n) + granularity - 1) // granularity) * granularity)


def required_keyframes(duration: float, cfg: ModelConfig) -> int:
    """Keyframe count needed to cover `duration`."""
    return (
        math.ceil((int(duration) + cfg.time_shift + cfg.time_pad * 2 + 1) / cfg.time_interval)
        + 1
        + 2
    )


def _empty_static(cap: int, sh_degree: int, dev) -> dict:
    f_rest = (sh_degree + 1) ** 2 - 1
    f32 = dict(dtype=torch.float32, device=dev)
    rot = torch.zeros((cap, 4), **f32)
    rot[:, 0] = 1.0
    return {
        "xyz": torch.zeros((cap, 3), **f32),
        "f_dc": torch.zeros((cap, 1, 3), **f32),
        "f_rest": torch.zeros((cap, f_rest, 3), **f32),
        "opacity": torch.full((cap, 1), -10.0, **f32),  # sigmoid ~ 0
        "scaling": torch.full((cap, 3), -10.0, **f32),  # exp ~ 0
        "rotation": rot,
        "xyz_disp": torch.zeros((cap, 3), **f32),
    }


def _empty_dynamic(cap: int, kf_cap: int, sh_degree: int, dev,
                   tangents: bool = False) -> dict:
    f_rest = (sh_degree + 1) ** 2 - 1
    f32 = dict(dtype=torch.float32, device=dev)
    rot = torch.zeros((cap, kf_cap, 4), **f32)
    rot[..., 0] = 1.0
    out = {
        "motion_xyz": torch.zeros((cap, kf_cap, 3), **f32),
        "motion_f_dc": torch.zeros((cap, 1, 3), **f32),
        "motion_f_rest": torch.zeros((cap, f_rest, 3), **f32),
        "motion_scaling": torch.full((cap, 3), -10.0, **f32),
        "motion_opacity": torch.full((cap, 1), -10.0, **f32),
        "motion_opacity_center": torch.zeros((cap, 2), **f32),
        "motion_opacity_var": torch.zeros((cap, 2), **f32),
        "motion_rotation": rot,
    }
    if tangents:
        out["motion_xyz_d"] = torch.zeros((cap, kf_cap, 3), **f32)
    return out


def _init_stats(static_cap: int, dynamic_cap: int, dev) -> dict:
    """Fresh accumulators: min radii and error minima start at 1000, the
    error-minimum timestamps at -1 (never seen), everything else at 0."""
    s = {}
    for keys, cap in ((STATIC_STAT_KEYS, static_cap), (DYNAMIC_STAT_KEYS, dynamic_cap)):
        for k in keys:
            if "min_radii" in k or ("error_min" in k and "timestamp" not in k):
                fill = 1000.0
            elif "timestamp" in k:
                fill = -1.0
            else:
                fill = 0.0
            s[k] = torch.full((cap,), fill, dtype=torch.float32, device=dev)
    return s


def empty_model(cfg: ModelConfig, static_capacity: int = CAPACITY_GRANULARITY,
                dynamic_capacity: int = 0, keyframe_capacity: int | None = None,
                duration: float | None = None, device=None) -> GaussianModel:
    dev = resolve_device(device)
    dur = float(duration if duration is not None else max(cfg.start_duration, 1))
    if keyframe_capacity is None:
        max_dur = cfg.duration if cfg.duration > 0 else dur
        keyframe_capacity = required_keyframes(max_dur, cfg) + 2
    params = _empty_static(static_capacity, cfg.sh_degree, dev)
    params.update(_empty_dynamic(dynamic_capacity, keyframe_capacity, cfg.sh_degree, dev,
                                 tangents=cfg.interp_type == "cubic_diff"))
    return GaussianModel(
        params=params,
        static_mask=torch.zeros(static_capacity, dtype=torch.bool, device=dev),
        dynamic_mask=torch.zeros(dynamic_capacity, dtype=torch.bool, device=dev),
        stats=_init_stats(static_capacity, dynamic_capacity, dev),
        active_sh_degree=torch.zeros((), dtype=torch.int32, device=dev),
        duration=torch.tensor(dur, dtype=torch.float32, device=dev),
        keyframe_num=torch.zeros((), dtype=torch.int32, device=dev),
    )


def create_from_pcd(points: np.ndarray, colors: np.ndarray, cfg: ModelConfig,
                    duration: float | None = None, static_capacity: int | None = None,
                    dynamic_capacity: int = 0, keyframe_capacity: int | None = None,
                    device=None) -> GaussianModel:
    """Static cloud from a coloured point cloud: SH DC from RGB, log-scales
    from sqrt(mean 3-NN squared distance), opacity sigmoid^-1(0.1),
    identity quaternions, zero displacement."""
    n = points.shape[0]
    cap = static_capacity or round_capacity(n)
    model = empty_model(cfg, cap, dynamic_capacity, keyframe_capacity, duration, device)
    dev = model.device

    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    dist2 = torch.clamp_min(mean_knn_dist2(pts), 1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    p = model.params
    p["xyz"][:n] = pts
    p["f_dc"][:n, 0] = rgb_to_sh0(torch.as_tensor(np.asarray(colors, np.float32), device=dev))
    p["scaling"][:n] = scales
    p["opacity"][:n] = inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=torch.float32, device=dev))
    model.static_mask[:n] = True
    return model


def oneup_sh_degree(model: GaussianModel, max_degree: int) -> GaussianModel:
    return model.replace(active_sh_degree=torch.clamp_max(model.active_sh_degree + 1, max_degree))


# ---------------------------------------------------------------------------
# Weights carried across: the JAX model's arrays (as numpy) <-> GaussianModel
# ---------------------------------------------------------------------------

def _expected_shapes(params: dict) -> dict:
    """name -> expected shape, derived from the capacities and SH width the
    arrays themselves declare (xyz, motion_xyz and f_rest)."""
    Ps = params["xyz"].shape[0]
    Pd, K = params["motion_xyz"].shape[:2]
    n_rest = params["f_rest"].shape[1]
    shapes = {
        "xyz": (Ps, 3), "f_dc": (Ps, 1, 3), "f_rest": (Ps, n_rest, 3),
        "opacity": (Ps, 1), "scaling": (Ps, 3), "rotation": (Ps, 4),
        "xyz_disp": (Ps, 3),
        "motion_xyz": (Pd, K, 3), "motion_f_dc": (Pd, 1, 3),
        "motion_f_rest": (Pd, n_rest, 3), "motion_scaling": (Pd, 3),
        "motion_opacity": (Pd, 1), "motion_opacity_center": (Pd, 2),
        "motion_opacity_var": (Pd, 2), "motion_rotation": (Pd, K, 4),
        "motion_xyz_d": (Pd, K, 3),
    }
    shapes.update({k: (Ps,) for k in STATIC_STAT_KEYS})
    shapes.update({k: (Pd,) for k in DYNAMIC_STAT_KEYS})
    return shapes


def _check(kind: str, got: dict, required: tuple, optional: tuple = ()):
    names = set(got)
    missing = set(required) - names
    extra = names - set(required) - set(optional)
    if missing or extra:
        raise ValueError(f"{kind} names differ: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")


def model_from_numpy(params: dict, static_mask, dynamic_mask, stats: dict,
                     active_sh_degree, duration, keyframe_num,
                     device=None) -> GaussianModel:
    """Build a GaussianModel from the JAX model's arrays as numpy, name for
    name (`{k: np.asarray(v) for k, v in jax_model.params.items()}` and so
    on). Checks names, shapes and dtypes and raises ValueError on any
    mismatch; copies the data onto `device` (cuda unless told otherwise)."""
    dev = resolve_device(device)
    _check("param", params, STATIC_KEYS + DYNAMIC_KEYS, ("motion_xyz_d",))
    _check("stat", stats, STATIC_STAT_KEYS + DYNAMIC_STAT_KEYS)
    shapes = _expected_shapes(params)
    Ps, Pd = shapes["xyz"][0], shapes["motion_xyz"][0]
    arrays = {**{("param", k): v for k, v in params.items()},
              **{("stat", k): v for k, v in stats.items()}}
    for (kind, k), v in arrays.items():
        v = np.asarray(v)
        if v.dtype != np.float32:
            raise ValueError(f"{kind} {k}: dtype {v.dtype}, expected float32")
        if v.shape != shapes[k]:
            raise ValueError(f"{kind} {k}: shape {v.shape}, expected {shapes[k]}")
    for name, m, n in (("static_mask", static_mask, Ps), ("dynamic_mask", dynamic_mask, Pd)):
        m = np.asarray(m)
        if m.dtype != np.bool_ or m.shape != (n,):
            raise ValueError(f"{name}: {m.dtype}{m.shape}, expected bool({n},)")
    scalars = {"active_sh_degree": (active_sh_degree, np.int32),
               "duration": (duration, np.float32),
               "keyframe_num": (keyframe_num, np.int32)}
    for name, (v, dt) in scalars.items():
        v = np.asarray(v)
        if v.shape != () or v.dtype != dt:
            raise ValueError(f"{name}: {v.dtype}{v.shape}, expected 0-d {np.dtype(dt)}")

    def t(v):
        return torch.as_tensor(np.array(v), device=dev)

    return GaussianModel(
        params={k: t(v) for k, v in params.items()},
        static_mask=t(static_mask),
        dynamic_mask=t(dynamic_mask),
        stats={k: t(v) for k, v in stats.items()},
        active_sh_degree=t(active_sh_degree),
        duration=t(duration),
        keyframe_num=t(keyframe_num),
    )


def model_to_numpy(model: GaussianModel) -> dict:
    """Inverse of model_from_numpy: the keyword arguments that rebuild the
    model (`model_from_numpy(**model_to_numpy(m))`), as numpy arrays."""
    def n(v):
        return v.detach().cpu().numpy()

    return dict(
        params={k: n(v) for k, v in model.params.items()},
        static_mask=n(model.static_mask),
        dynamic_mask=n(model.dynamic_mask),
        stats={k: n(v) for k, v in model.stats.items()},
        active_sh_degree=n(model.active_sh_degree),
        duration=n(model.duration),
        keyframe_num=n(model.keyframe_num),
    )
