"""Object-oriented facade over the functional core — the reference's
CGaussianModel/Scene method surface (scene/c_gaussian_model.py:28-1358) for
users migrating from the PyTorch codebase.

Counterpart of `ex4dgs_tpu/compat.py`. The functional API (models/, train/,
rendering.py) is the primary surface; this adapter holds a model, its
optimizer state and its config on one device (cuda unless told otherwise)
behind the familiar names. Each method documents the functional call it
forwards to.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import resolve_device
from .models import density as D
from .models import temporal
from .models.config import ModelConfig, OptimizationConfig
from .models.optimizer import init_state
from .models.state import create_from_pcd, oneup_sh_degree
from .ops.math3d import cov3d_from_scaling_rotation


class CGaussianModel:
    """Drop-in-feel adapter: holds (model, optimizer state, config)."""

    def __init__(self, sh_degree: int, duration: int, interval: int, time_pad: int = 1,
                 interp_type: str = "linear", rot_interp_type: str = "slerp",
                 time_pad_type: int = 0, var_pad: int = 3, kernel_size: float = 0.1,
                 device=None, **_kw):
        self.device = resolve_device(device)
        self.cfg = ModelConfig(
            sh_degree=sh_degree, time_interval=interval, time_pad=time_pad,
            var_pad=var_pad, time_pad_type=time_pad_type, kernel_size=kernel_size,
            interp_type=interp_type, rot_interp_type=rot_interp_type,
            start_duration=max(duration, 1),
        )
        self.model = None
        self.opt_state = None
        self.spatial_lr_scale = 0.0
        self._duration = max(duration, 1)

    # -- properties matching the reference's getters --------------------
    @property
    def duration(self):
        return float(self.model.duration) if self.model is not None else self._duration

    @property
    def interval(self):
        return self.cfg.time_interval

    @property
    def time_shift(self):
        return self.cfg.time_shift

    @property
    def keyframe_num(self):
        return int(self.model.keyframe_num)

    @property
    def active_sh_degree(self):
        return int(self.model.active_sh_degree)

    @property
    def max_sh_degree(self):
        return self.cfg.sh_degree

    # -- model construction ---------------------------------------------
    def create_from_pcd(self, points, colors, spatial_lr_scale: float):
        """c_gaussian_model.py:385-410."""
        self.spatial_lr_scale = spatial_lr_scale
        self.model = create_from_pcd(np.asarray(points), np.asarray(colors), self.cfg,
                                     duration=self._duration, device=self.device)
        return self

    def training_setup(self, training_args: OptimizationConfig):
        """c_gaussian_model.py:412-459 — optimizer state init (per-group LRs
        live in models/optimizer.py:group_lrs)."""
        self.opt = training_args
        self.opt_state = init_state(self.model.params, device=self.device)
        return self

    # -- temporal queries (c_gaussian_model.py:170-379) ------------------
    def _at(self, t, mode: int):
        return temporal.point_data_at_t(self.model, self.cfg, t, mode=mode)

    def get_xyz_at_t(self, t, mode: int = 0):
        return self._at(t, mode).means3d

    def get_rotation_at_t(self, t, mode: int = 0):
        return self._at(t, mode).rotations

    def get_opacity_at_t(self, t, mode: int = 0):
        return self._at(t, mode).opacity

    def get_scaling(self, mode: int = 0):
        return self._at(0.0, mode).scales

    def get_features(self, mode: int = 0):
        return self._at(0.0, mode).features

    def get_covariance_at_t(self, t, scaling_modifier: float = 1.0, mode: int = 0):
        pts = self._at(t, mode)
        return cov3d_from_scaling_rotation(pts.scales, pts.rotations, scaling_modifier)

    def oneupSHdegree(self):
        self.model = oneup_sh_degree(self.model, self.cfg.sh_degree)

    # -- density control (host events, models/density.py) ----------------
    def _event(self, fn):
        hm = D.pull(self.model, self.opt_state)
        out = fn(hm)
        self.model, self.opt_state = D.push(hm, self.cfg, device=self.device)
        return out

    def densify_and_prune(self, max_grad, max_dgrad, min_opacity, min_motion_opacity, extent,
                          *_, rng=None, **kw):
        opt = dataclasses.replace(getattr(self, "opt", OptimizationConfig()),
                                  densify_grad_threshold=max_grad,
                                  densify_dgrad_threshold=max_dgrad)
        return self._event(lambda hm: D.densify_and_prune(
            hm, self.cfg, opt, extent, rng or np.random.default_rng(0),
            min_opacity=min_opacity, min_motion_opacity=min_motion_opacity, **kw))

    def prune_invisible(self):
        return self._event(D.prune_invisible)

    def prune_small(self):
        return self._event(D.prune_small)

    def prune_nan_points(self):
        return self._event(D.prune_nan)

    def reset_opacity(self):
        return self._event(D.reset_opacity)

    def extract_dynamic_points_from_static(self, viewpoint_loc, timestamp, vis_filter, extent,
                                           percentile=0.98, max_dur=None):
        loc = np.asarray(viewpoint_loc, np.float32).reshape(-1)[:3]
        return self._event(lambda hm: D.extract_dynamic_from_static(
            hm, self.cfg, loc, timestamp, np.asarray(vis_filter, bool), extent,
            percentile=percentile, max_dur=max_dur))

    def expand_duration(self, duration):
        return self._event(lambda hm: D.expand_duration(hm, self.cfg, duration))

    def adjust_temp_opa(self, max_dur=None):
        return self._event(lambda hm: D.adjust_temp_opa(hm, self.cfg, max_dur))

    # -- checkpoint / PLY (io/) ------------------------------------------
    def capture(self):
        """c_gaussian_model.py:217-260 — full state snapshot."""
        return D.pull(self.model, self.opt_state)

    def restore(self, hm, training_args=None):
        """c_gaussian_model.py:262-320."""
        self.model, self.opt_state = D.push(hm, self.cfg, device=self.device)
        if training_args is not None:
            self.opt = training_args
        return self

    def save_ply(self, path: str):
        from .io.model_ply import save_model_ply

        save_model_ply(D.pull(self.model, self.opt_state), path)

    def load_ply(self, path: str):
        from .io.model_ply import load_model_ply

        hm = load_model_ply(path, self.cfg, duration=self.duration)
        self.model, self.opt_state = D.push(hm, self.cfg, device=self.device)
        return self


def getmodel(model: str = "cubic"):
    """scene/__init__.py:277-281."""
    if model == "cubic":
        return CGaussianModel
    raise NotImplementedError(f"model {model} not implemented")
