"""Configuration: the port's own copy of `ex4dgs_tpu/models/config.py`
(the model and optimization groups). Same fields, same defaults,
same JSON overlay rule (unknown keys skipped), so one JSON config drives
both packages.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Scene/model parameters (the reference's arguments/__init__.py:47-81)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = True
    model: str = "cubic"
    loader: str = "neural3dvideo"
    interp_type: str = "cube"
    rot_interp_type: str = "slerp"
    lazy_loader: bool = True
    llffhold: int = 8
    time_interval: int = 5
    time_pad: int = 3
    var_pad: int = 3
    time_pad_type: int = 0  # 0: none, 1: reflect, 2: repeat
    kernel_size: float = 0.1
    start_duration: int = 5
    duration: int = -1
    sample_every: int = 1
    progressive_step: float = 1
    start_timestamp: int = 0
    end_timestamp: int = -1
    near: float = 0.2
    far: float = 300.0

    @property
    def time_shift(self) -> int:
        """time_pad, plus one interval for the 4-point interpolators that
        need a lead-in keyframe."""
        if self.interp_type in ("cube", "pchip"):
            return self.time_pad + self.time_interval
        return self.time_pad


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """Training schedule and learning rates (the reference's
    arguments/__init__.py:90-139)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    dynamic_position_lr_init: float = 0.00016
    dynamic_position_lr_final: float = 0.000016
    dynamic_position_lr_delay_mult: float = 0.01
    dynamic_position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.00001
    disp_lr: float = 0.0001
    feature_motion_lr: float = 0.0025
    rotation_motion_lr: float = 0.001
    opacity_motion_lr: float = 0.05
    opacity_motion_center_lr: float = 0.001
    opacity_motion_var_lr: float = 0.0005
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    l1_accum: bool = True
    densification_interval: int = 200
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    extract_from_iter: int = 500
    densify_until_iter: int = 15_000
    progressive_growing_steps: int = 300
    error_base_prune_steps: int = 20000
    ssim_prune_every: int = 5
    l1_prune_every: int = 5
    make_dynamic_interval: int = 200
    extracton_interval: int = 3000
    extract_every: int = 1
    extract_percentile: float = 0.98
    prune_invisible_interval: int = 6000
    densify_grad_threshold: float = 0.0002
    densify_dgrad_threshold: float = 0.0001
    s_max_ssim: float = 0.6
    s_l1_thres: float = 0.08
    d_max_ssim: float = 0.6
    d_l1_thres: float = 0.08
    static_reg: float = 0.0001
    motion_reg: float = 0.0001
    rot_reg: float = 0.00
    coord_reg: float = 0.00
    random_background: bool = True


@dataclasses.dataclass(frozen=True)
class Model4DConfig:
    """4D Gaussian Splatting's model (Yang et al., ICLR 2024; its dynerf
    configs): SH degree in space and in time, the time span the harmonics'
    period is taken over, the projection's frustum and 2D dilation."""

    sh_degree: int = 3
    sh_degree_t: int = 2
    time_duration: tuple = (0.0, 10.0)  # (start, end) in seconds
    near: float = 0.2
    far: float = 100.0
    dilation: float = 0.3  # added to the 2D covariance's diagonal, no compensation

    @property
    def time_span(self) -> float:
        return float(self.time_duration[1]) - float(self.time_duration[0])


@dataclasses.dataclass(frozen=True)
class Optimization4DConfig:
    """4D Gaussian Splatting's training recipe (the dynerf configs): L1 +
    SSIM over a batch of views a step (the caller's), Adam with the
    per-group rates below (t on the position schedule)."""

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lambda_dssim: float = 0.2
    densify_until_iter: int = 15_000
    adam_eps: float = 1e-15


@dataclasses.dataclass(frozen=True)
class ModelDeformConfig:
    """4D-GS's model (Wu et al., CVPR 2024; its dynerf arguments): canonical
    3DGS Gaussians deformed at time t by a HexPlane field of `multires`
    scales (6 planes each, `output_coordinate_dim` channels, `resolution`
    (x, y, z, t) cells at scale 1, the spatial ones times the scale) and an
    MLP of `net_width` with `defor_depth` hidden layers before five heads;
    the projection's frustum and 3DGS's uncompensated 2D dilation."""

    sh_degree: int = 3
    multires: tuple = (1, 2)
    resolution: tuple = (64, 64, 64, 150)
    output_coordinate_dim: int = 16
    net_width: int = 128
    defor_depth: int = 0
    near: float = 0.2
    far: float = 100.0
    dilation: float = 0.3


@dataclasses.dataclass(frozen=True)
class OptimizationDeformConfig:
    """4D-GS's fine-stage recipe (dynerf): L1 over a batch of views plus the
    planes' smoothness and time-plane regularizers, Adam over eight groups,
    the means, the deformation MLP and the grid on exponential schedules
    (times the spatial scale)."""

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 20_000
    deformation_lr_init: float = 0.00016
    deformation_lr_final: float = 0.000016
    deformation_lr_delay_mult: float = 0.01
    grid_lr_init: float = 0.0016
    grid_lr_final: float = 0.00016
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    plane_tv_weight: float = 0.0002
    time_smoothness_weight: float = 0.001
    l1_time_planes: float = 0.0001
    lambda_dssim: float = 0.0
    densify_until_iter: int = 10_000
    adam_eps: float = 1e-15


def overlay_json(cfg: Any, json_path_or_dict) -> Any:
    """Overlay JSON keys onto a frozen dataclass, skipping unknown keys."""
    if isinstance(json_path_or_dict, str):
        with open(json_path_or_dict) as f:
            data = json.load(f)
    else:
        data = dict(json_path_or_dict)
    fields = {f.name for f in dataclasses.fields(cfg)}
    return dataclasses.replace(cfg, **{k: v for k, v in data.items() if k in fields})


def load_configs(json_path: str) -> tuple[ModelConfig, OptimizationConfig]:
    """(model, optimization) configs from one JSON file, each taking the
    keys it knows. The reference's pipeline toggles (JAX's PipelineConfig)
    are not kept: nothing in the port reads them."""
    with open(json_path) as f:
        data = json.load(f)
    return overlay_json(ModelConfig(), data), overlay_json(OptimizationConfig(), data)
