"""Temporal queries: the per-frame rasterizer inputs at timestamp t.

Counterpart of `ex4dgs_tpu/models/temporal.py`. `mode` selects the point set
as in the reference: 0 = static + dynamic concatenated, 1 = static only,
2 = dynamic only. Inactive capacity rows carry a False mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import scalar_on
from ..ops import interpolation as interp
from .config import ModelConfig
from .state import GaussianModel


class PointData(NamedTuple):
    """Per-frame rasterizer inputs for P = Ps(+Pd) capacity rows."""

    means3d: torch.Tensor  # [P, 3]
    rotations: torch.Tensor  # [P, 4] raw (unnormalized) quaternions
    scales: torch.Tensor  # [P, 3] activated (exp)
    opacity: torch.Tensor  # [P] activated (sigmoid x temporal envelope)
    features: torch.Tensor  # [P, (deg+1)^2, 3] SH coefficients
    mask: torch.Tensor  # [P] bool active rows
    static_num: int  # rows [0:static_num] are the static group


def _interp_kind(kind: str) -> str:
    return "cube" if kind == "cubic" else kind  # model-name alias


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def point_data_at_t(model: GaussianModel, cfg: ModelConfig, t,
                    mode: int = 0) -> PointData:
    """Assemble all rasterizer inputs for timestamp t. A host number picks
    the keyframes on the host and slices them, and is filled in on the
    model's device; a 0-d tensor picks and gathers them on its device
    (`interpolation.gather_keyframes`), and is never read back, so that a
    CUDA graph replays the query for whatever t it finds there. Either way
    the query reads nothing back from the device."""
    p = model.params
    t_host = None if isinstance(t, torch.Tensor) else t
    t = scalar_on(t, model.device)
    use_static = mode in (0, 1)
    use_dynamic = mode in (0, 2) and model.dynamic_capacity > 0

    xyz, rot, scale, op, feat, mask = [], [], [], [], [], []
    static_num = 0
    if use_static:
        static_num = model.static_capacity
        xyz.append(p["xyz"] + p["xyz_disp"] * (t / model.duration))
        rot.append(p["rotation"])
        scale.append(torch.exp(p["scaling"]))
        op.append(torch.squeeze(_sigmoid(p["opacity"]), -1))
        feat.append(torch.cat([p["f_dc"], p["f_rest"]], dim=1))
        mask.append(model.static_mask)
    if use_dynamic:
        tu = (t + cfg.time_shift) / cfg.time_interval
        env = interp.time_bigaussian(p["motion_opacity_center"], p["motion_opacity_var"],
                                     tu, var_min=cfg.var_pad / cfg.time_interval)
        k, dt = interp.keyframe_coords(t, cfg.time_shift, cfg.time_interval, t_host=t_host)
        xyz.append(interp.interp_keyframes(_interp_kind(cfg.interp_type), p["motion_xyz"],
                                           k, dt, y_d=p.get("motion_xyz_d")))
        rot.append(interp.interp_quat_keyframes(cfg.rot_interp_type, p["motion_rotation"],
                                                k, dt))
        scale.append(torch.exp(p["motion_scaling"]))
        op.append(torch.squeeze(_sigmoid(p["motion_opacity"]), -1) * env)
        feat.append(torch.cat([p["motion_f_dc"], p["motion_f_rest"]], dim=1))
        mask.append(model.dynamic_mask)

    features = torch.cat(feat, dim=0)
    # Zero the SH bands above the active degree (SH is linear in its
    # coefficients, so this equals evaluating the lower degree).
    band = torch.arange(features.shape[1], device=features.device)
    band_ok = band < (model.active_sh_degree + 1) ** 2
    features = features * band_ok[None, :, None]

    return PointData(
        means3d=torch.cat(xyz, dim=0),
        rotations=torch.cat(rot, dim=0),
        scales=torch.cat(scale, dim=0),
        opacity=torch.cat(op, dim=0),
        features=features,
        mask=torch.cat(mask, dim=0),
        static_num=static_num,
    )
