"""Public render API: render a model at a timestamp.

Counterpart of `ex4dgs_tpu/rendering.py`. `render(cam, model, cfg, t=...,
bg=...)` returns the same outputs: color, depth, optical flow, accumulated
alpha, dominant-contributor index, per-splat radii and visibility. The
compositor is chosen by the device of the tensors: on CUDA the
forward-compositing kernel runs, on the CPU its plain version.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device
from .kernel_config import KernelConfig
from .models.config import ModelConfig
from .models.state import GaussianModel
from .models.temporal import PointData, point_data_at_t
from .ops import binning as binning_ops
from .ops.math3d import cov3d_from_scaling_rotation, sh_to_rgb
from .ops.projection import CameraArrays, Projected, project_gaussians, tile_grid
from .ops.rasterize_cuda import rasterize_tiled_cuda


@dataclasses.dataclass
class RenderCamera:
    """Camera on one device: matrices as float32 tensors, size in pixels."""

    view: torch.Tensor  # [4,4] world->camera
    proj: torch.Tensor  # [4,4] P @ view
    campos: torch.Tensor  # [3]
    width: int
    height: int
    tan_fovx: torch.Tensor  # [] tan(fovx / 2)
    tan_fovy: torch.Tensor  # []

    @classmethod
    def from_numpy(cls, view, proj, campos, width, height, tan_fovx, tan_fovy,
                   device=None) -> "RenderCamera":
        """A camera from numpy arrays (e.g. the JAX package's RenderCamera
        fields via np.asarray). Checks shapes and raises on a mismatch."""
        dev = resolve_device(device)
        shapes = {"view": (view, (4, 4)), "proj": (proj, (4, 4)), "campos": (campos, (3,)),
                  "tan_fovx": (tan_fovx, ()), "tan_fovy": (tan_fovy, ())}
        arrs = {}
        for name, (v, shape) in shapes.items():
            v = np.asarray(v, np.float32)
            if v.shape != shape:
                raise ValueError(f"camera {name}: shape {v.shape}, expected {shape}")
            arrs[name] = torch.as_tensor(v.copy(), device=dev)
        return cls(width=int(width), height=int(height), **arrs)

    @classmethod
    def from_fov(cls, view, proj, campos, width, height, fovx, fovy,
                 device=None) -> "RenderCamera":
        return cls.from_numpy(view, proj, campos, width, height, math.tan(fovx * 0.5),
                              math.tan(fovy * 0.5), device=device)

    @property
    def arrays(self) -> CameraArrays:
        return CameraArrays(view=self.view, proj=self.proj, campos=self.campos)


class RenderResult(NamedTuple):
    render: torch.Tensor  # [H, W, 3]
    depth: torch.Tensor  # [H, W]
    opticalflow: torch.Tensor  # [H, W, 3]
    acc: torch.Tensor  # [H, W]
    dominent_idxs: torch.Tensor  # [H, W] int32 (-1 empty)
    radii: torch.Tensor  # [P] int32
    visibility_filter: torch.Tensor  # [P] bool (radii > 0)
    static_num: int
    projected: Projected
    binning_total: torch.Tensor  # [] int32 true instance count (overflow check)


def _on(dev: torch.device, name: str, t: torch.Tensor) -> torch.Tensor:
    if t.device.type != dev.type or (dev.index is not None and t.device != dev):
        raise ValueError(f"{name} is on {t.device}, the render runs on {dev}")
    return t


def render_points(pts: PointData, cam: RenderCamera, cfg: ModelConfig, *, bg,
                  near: float | None = None, far: float | None = None,
                  scaling_modifier: float = 1.0, capacity: int | None = None,
                  mean2d_offset=None, flow_dirs=None, override_color=None,
                  subpixel_offset=None, track_idx: bool = True,
                  kernel_cfg: KernelConfig | None = None, device=None) -> RenderResult:
    """Rasterize pre-assembled per-frame point data on `device` (cuda
    unless told otherwise; the points and camera must already be there).
    subpixel_offset: optional f32 [H, W, 2] per-pixel anti-aliasing
    offsets on that device (see composite_projected)."""
    dev = resolve_device(device)
    _on(dev, "the point data", pts.means3d)
    _on(dev, "the camera", cam.view)
    near = cfg.near if near is None else near
    far = cfg.far if far is None else far
    kcfg = (kernel_cfg or KernelConfig()).validate()
    P = pts.means3d.shape[0]
    if capacity is None:
        capacity = default_capacity(P, cam.width, cam.height, kcfg)
    if flow_dirs is None:
        flow_dirs = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    proj, colors = preprocess_points(pts, cam, cfg, near=near, far=far,
                                     scaling_modifier=scaling_modifier,
                                     mean2d_offset=mean2d_offset,
                                     override_color=override_color, kernel_cfg=kcfg)
    return composite_projected(proj, colors, flow_dirs, cam, bg=bg, far=far,
                               capacity=capacity, static_num=pts.static_num,
                               subpixel_offset=subpixel_offset, track_idx=track_idx,
                               kernel_cfg=kcfg)


def preprocess_points(pts: PointData, cam: RenderCamera, cfg: ModelConfig, *, near: float,
                      far: float, scaling_modifier: float = 1.0, mean2d_offset=None,
                      override_color=None, kernel_cfg: KernelConfig | None = None):
    """Per-Gaussian stage: covariance, EWA projection, SH -> RGB."""
    kcfg = kernel_cfg or KernelConfig()
    cov3d = cov3d_from_scaling_rotation(pts.scales, pts.rotations, scaling_modifier)
    proj = project_gaussians(pts.means3d, cov3d, pts.opacity, cam.arrays, width=cam.width,
                             height=cam.height, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
                             kernel_size=cfg.kernel_size, min_depth=near, max_depth=far,
                             mean2d_ndc_offset=mean2d_offset, tile_x=kcfg.tile_x,
                             tile_y=kcfg.tile_y)
    # Capacity-padding mask: inactive rows are simply invalid.
    zero_i = torch.zeros_like(proj.tiles_touched)
    proj = proj._replace(
        valid=proj.valid & pts.mask,
        tiles_touched=torch.where(pts.mask, proj.tiles_touched, zero_i),
        radius=torch.where(pts.mask, proj.radius, zero_i),
    )
    if override_color is not None:
        colors = override_color
    else:
        colors = sh_to_rgb(3, pts.features, pts.means3d, cam.campos)
    return proj, colors


def composite_projected(proj: Projected, colors, flow_dirs, cam: RenderCamera, *, bg,
                        far: float, capacity: int, static_num: int = 0,
                        subpixel_offset=None, track_idx: bool = True,
                        kernel_cfg: KernelConfig | None = None) -> RenderResult:
    """Binning and tile compositing of already-projected Gaussians.
    subpixel_offset: optional f32 [H, W, 2] on the render's device; pixel
    (x, y) is evaluated at (x + off[y, x, 0], y + off[y, x, 1]). The offsets
    are data: no gradient reaches them."""
    kcfg = kernel_cfg or KernelConfig()
    if subpixel_offset is not None:
        _on(proj.xy.device, "subpixel_offset", subpixel_offset)
        shape = (cam.height, cam.width, 2)
        if tuple(subpixel_offset.shape) != shape or subpixel_offset.dtype != torch.float32:
            raise ValueError(f"subpixel_offset: {subpixel_offset.dtype} "
                             f"{tuple(subpixel_offset.shape)}, expected float32 {shape}")
    grid_x, grid_y = tile_grid(cam.width, cam.height, kcfg.tile_x, kcfg.tile_y)
    binning = binning_ops.bin_gaussians(proj, grid_x, grid_y, capacity,
                                        exact_depth_sort=kcfg.exact_sort)
    out = rasterize_tiled_cuda(proj, colors, flow_dirs, binning, width=cam.width,
                               height=cam.height, bg=bg, max_depth=far, tile_x=kcfg.tile_x,
                               tile_y=kcfg.tile_y, track_idx=track_idx,
                               subpixel_offset=subpixel_offset)
    return RenderResult(
        render=out.color,
        depth=out.depth,
        opticalflow=out.flow,
        acc=out.acc,
        dominent_idxs=out.idx,
        radii=proj.radius,
        visibility_filter=proj.radius > 0,
        static_num=static_num,
        projected=proj,
        binning_total=binning.total,
    )


def render(cam: RenderCamera, model: GaussianModel, cfg: ModelConfig, *, t, bg,
           mode: int = 0, device=None, **kwargs) -> RenderResult:
    """Render the model at timestamp t on `device` (cuda unless told
    otherwise; the model and camera must already be there)."""
    dev = resolve_device(device)
    _on(dev, "the model", model.params["xyz"])
    pts = point_data_at_t(model, cfg, t, mode=mode)
    return render_points(pts, cam, cfg, bg=bg, device=dev, **kwargs)


def default_capacity(num_points: int, width: int, height: int,
                     kernel_cfg: KernelConfig | None = None) -> int:
    """Instance-buffer size: a generous tiles-per-splat allowance, rounded
    to a bucket."""
    kcfg = kernel_cfg or KernelConfig()
    grid_x, grid_y = tile_grid(width, height, kcfg.tile_x, kcfg.tile_y)
    return binning_ops.required_capacity(max(8 * num_points, 64 * grid_x * grid_y))
