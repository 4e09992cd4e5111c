"""Model configuration: the port's own copy of `ex4dgs_tpu/models/config.py`
(the parts the render path reads). Same fields, same defaults, same JSON
overlay rule (unknown keys skipped), so one JSON config drives both packages.
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


def overlay_json(cfg: Any, json_path_or_dict) -> Any:
    """Overlay JSON keys onto a frozen dataclass, skipping unknown keys."""
    if isinstance(json_path_or_dict, str):
        with open(json_path_or_dict) as f:
            data = json.load(f)
    else:
        data = dict(json_path_or_dict)
    fields = {f.name for f in dataclasses.fields(cfg)}
    return dataclasses.replace(cfg, **{k: v for k, v in data.items() if k in fields})
