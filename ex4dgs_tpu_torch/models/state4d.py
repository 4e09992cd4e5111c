"""4D Gaussian Splatting's model state (Yang et al., ICLR 2024): one
capacity-padded set of 4D Gaussians with no static/dynamic split and no
keyframes.

Each Gaussian has a 4D mean (`xyz`, `t`), 4D log-scales (`scaling`,
`scaling_t`), a left and a right quaternion (`rotation`, `rotation_r`)
whose product is its 4D rotation, an opacity logit, and features of
(sh_degree + 1)^2 (sh_degree_t + 1) rows (`f_dc`, the first; `f_rest`),
under the source's parameter names. Rows past the active ones hold the
empty values of `empty_model` and are left out by `mask`. The
densification statistics are the source's largest screen radius
(`max_radii2D`), summed screen-space mean-gradient norm
(`xyz_gradient_accum`) and count (`denom`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from .config import Model4DConfig
from .state import round_capacity

PARAM_KEYS = ("xyz", "t", "scaling", "scaling_t", "rotation", "rotation_r", "opacity", "f_dc",
              "f_rest")
STAT_KEYS = ("max_radii2D", "xyz_gradient_accum", "denom")


def feature_rows(sh_degree: int, sh_degree_t: int) -> int:
    """Feature rows of one Gaussian: (sh_degree + 1)^2 per time band, one
    band per time degree 0 .. sh_degree_t."""
    return (sh_degree + 1) ** 2 * (sh_degree_t + 1)


@dataclasses.dataclass
class Gaussian4DModel:
    """All 4D model state on one device; the scalars are 0-d tensors."""

    params: dict  # name -> [P, ...] float32, see PARAM_KEYS
    mask: torch.Tensor  # [P] bool, active Gaussians
    stats: dict  # name -> [P] float32, see STAT_KEYS
    active_sh_degree: torch.Tensor  # [] int32
    active_sh_degree_t: torch.Tensor  # [] int32

    @property
    def capacity(self) -> int:
        return self.params["xyz"].shape[0]

    @property
    def device(self) -> torch.device:
        return self.params["xyz"].device

    def replace(self, **changes) -> "Gaussian4DModel":
        return dataclasses.replace(self, **changes)


def _shapes(capacity: int, n_rest: int) -> dict:
    return {"xyz": (capacity, 3), "t": (capacity, 1), "scaling": (capacity, 3),
            "scaling_t": (capacity, 1), "rotation": (capacity, 4), "rotation_r": (capacity, 4),
            "opacity": (capacity, 1), "f_dc": (capacity, 1, 3), "f_rest": (capacity, n_rest, 3)}


def empty_params(capacity: int, cfg: Model4DConfig, device) -> dict:
    """Inactive rows: zero means and features, identity quaternions,
    log-scales and opacity logit -10."""
    f32 = dict(dtype=torch.float32, device=device)
    n_rest = feature_rows(cfg.sh_degree, cfg.sh_degree_t) - 1
    out = {}
    for k, shape in _shapes(capacity, n_rest).items():
        if k in ("scaling", "scaling_t", "opacity"):
            out[k] = torch.full(shape, -10.0, **f32)
        elif k in ("rotation", "rotation_r"):
            out[k] = torch.zeros(shape, **f32)
            out[k][:, 0] = 1.0
        else:
            out[k] = torch.zeros(shape, **f32)
    return out


def empty_stats(capacity: int, device) -> dict:
    return {k: torch.zeros(capacity, dtype=torch.float32, device=device) for k in STAT_KEYS}


def empty_model(cfg: Model4DConfig, capacity: int, device=None) -> Gaussian4DModel:
    """A model of `capacity` rows (rounded up to the port's granularity),
    none active, at SH degrees 0."""
    dev = resolve_device(device)
    cap = round_capacity(capacity)
    i32 = dict(dtype=torch.int32, device=dev)
    return Gaussian4DModel(params=empty_params(cap, cfg, dev),
                           mask=torch.zeros(cap, dtype=torch.bool, device=dev),
                           stats=empty_stats(cap, dev), active_sh_degree=torch.zeros((), **i32),
                           active_sh_degree_t=torch.zeros((), **i32))


def oneup_sh_degree(model: Gaussian4DModel, max_degree: int,
                    max_degree_t: int) -> Gaussian4DModel:
    """One more degree in space and in time, each up to its maximum."""
    return model.replace(
        active_sh_degree=torch.clamp_max(model.active_sh_degree + 1, max_degree),
        active_sh_degree_t=torch.clamp_max(model.active_sh_degree_t + 1, max_degree_t))


def model_from_numpy(params: dict, mask, stats: dict, active_sh_degree, active_sh_degree_t,
                     device=None) -> Gaussian4DModel:
    """A Gaussian4DModel from numpy arrays, name for name. Checks names,
    shapes and dtypes and raises ValueError on a mismatch; copies the data
    onto `device` (cuda unless told otherwise)."""
    dev = resolve_device(device)
    for kind, got, want in (("param", params, PARAM_KEYS), ("stat", stats, STAT_KEYS)):
        if set(got) != set(want):
            raise ValueError(f"{kind} names differ: missing {sorted(set(want) - set(got))}, "
                             f"unexpected {sorted(set(got) - set(want))}")
    cap = np.asarray(params["xyz"]).shape[0]
    shapes = _shapes(cap, np.asarray(params["f_rest"]).shape[1])
    shapes.update({k: (cap,) for k in STAT_KEYS})
    for kind, d in (("param", params), ("stat", stats)):
        for k, v in d.items():
            v = np.asarray(v)
            if v.dtype != np.float32 or v.shape != shapes[k]:
                raise ValueError(f"{kind} {k}: {v.dtype}{v.shape}, expected float32{shapes[k]}")
    m = np.asarray(mask)
    if m.dtype != np.bool_ or m.shape != (cap,):
        raise ValueError(f"mask: {m.dtype}{m.shape}, expected bool({cap},)")
    degrees = []
    for name, v in (("active_sh_degree", active_sh_degree),
                    ("active_sh_degree_t", active_sh_degree_t)):
        v = np.asarray(v)
        if v.shape != () or v.dtype != np.int32:
            raise ValueError(f"{name}: {v.dtype}{v.shape}, expected 0-d int32")
        degrees.append(v)

    def t(v):
        return torch.as_tensor(np.array(v), device=dev)

    return Gaussian4DModel(params={k: t(v) for k, v in params.items()}, mask=t(m),
                           stats={k: t(v) for k, v in stats.items()},
                           active_sh_degree=t(degrees[0]), active_sh_degree_t=t(degrees[1]))


def model_to_numpy(model: Gaussian4DModel) -> dict:
    """Inverse of model_from_numpy: its keyword arguments as numpy arrays."""
    def n(v):
        return v.detach().cpu().numpy()

    return dict(params={k: n(v) for k, v in model.params.items()}, mask=n(model.mask),
                stats={k: n(v) for k, v in model.stats.items()},
                active_sh_degree=n(model.active_sh_degree),
                active_sh_degree_t=n(model.active_sh_degree_t))
