"""Public render API: render a model at a timestamp.

Counterpart of `ex4dgs_tpu/rendering.py`. `render(cam, model, cfg, t=...,
bg=...)` returns the same outputs: color, depth, optical flow, accumulated
alpha, dominant-contributor index, per-splat radii and visibility. The
compositor is chosen by the device of the tensors: on CUDA the
forward-compositing kernel runs, on the CPU its plain version.
`render4d(cam, model4d, cfg, t=..., bg=...)` renders the second model
family, 4D Gaussian Splatting (Yang et al.), and `render_deform(cam,
model, cfg, t=..., bg=...)` the third, 4D-GS (Wu et al.), through the same
projection, binning and compositing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device, upload
from .kernel_config import KernelConfig
from .models.config import Model4DConfig, ModelConfig, ModelDeformConfig
from .models.deform import DeformModel, deform
from .models.state import GaussianModel
from .models.state4d import Gaussian4DModel
from .models.temporal import PointData, point_data_at_t
from .ops import binning as binning_ops
from .ops.math3d import cov3d_from_scaling_rotation, sh_to_rgb
from .ops.projection import CameraArrays, Projected, project_gaussians, tile_grid
from .ops import compositing as comp
from .ops.rasterize_cuda import composite_blocks, rasterize_tiled_cuda
from .ops.slice4d import slice4d
from .parallel import collectives
from .runtime import graphs
from .runtime.profiling import span


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
        fields via np.asarray). Checks shapes and raises on a mismatch. The
        five fields go up as one packed float32 array (`upload`: pinned, no
        wait for the device) and are views of that one buffer."""
        dev = resolve_device(device)
        shapes = {"view": (view, (4, 4)), "proj": (proj, (4, 4)), "campos": (campos, (3,)),
                  "tan_fovx": (tan_fovx, ()), "tan_fovy": (tan_fovy, ())}
        flat = []
        for name, (v, shape) in shapes.items():
            v = np.asarray(v, np.float32)
            if v.shape != shape:
                raise ValueError(f"camera {name}: shape {v.shape}, expected {shape}")
            flat.append(v.reshape(-1))
        packed = upload(np.concatenate(flat), dev)
        fields, at = {}, 0
        for name, (_, shape) in shapes.items():
            n = math.prod(shape)
            fields[name] = packed[at:at + n].view(shape)
            at += n
        return cls(width=int(width), height=int(height), **fields)

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
    bg = upload(bg, dev, torch.float32)
    with span("ex4dgs.preprocess"):
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
    proj = _masked(proj, pts.mask)
    if override_color is not None:
        colors = override_color
    else:
        colors = sh_to_rgb(3, pts.features, pts.means3d, cam.campos)
    return proj, colors


def _masked(proj: Projected, mask) -> Projected:
    """proj with the rows outside `mask` invalid: no tiles, radius 0."""
    zero_i = torch.zeros_like(proj.tiles_touched)
    return proj._replace(
        valid=proj.valid & mask,
        tiles_touched=torch.where(mask, proj.tiles_touched, zero_i),
        radius=torch.where(mask, proj.radius, zero_i),
    )


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
    with span("ex4dgs.binning"):
        binning = binning_ops.bin_gaussians(proj, grid_x, grid_y, capacity,
                                            exact_depth_sort=kcfg.exact_sort,
                                            tight_cull=kcfg.tight_cull, tile_x=kcfg.tile_x,
                                            tile_y=kcfg.tile_y)
    with span("ex4dgs.composite"):
        out = rasterize_tiled_cuda(proj, colors, flow_dirs, binning, width=cam.width,
                                   height=cam.height, bg=bg, max_depth=far,
                                   tile_x=kcfg.tile_x, tile_y=kcfg.tile_y,
                                   track_idx=track_idx, subpixel_offset=subpixel_offset)
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


def composite_slab_rank(proj: Projected, colors, flow_dirs, cam: RenderCamera, *, bg,
                        far: float, capacity: int, rank: int, axis_size: int,
                        track_idx: bool = False, kernel_cfg: KernelConfig | None = None):
    """One rank's part of the tile-sharded compositing: (blocks, total).
    Rank `rank` of `axis_size` owns the slab of rows_per = ceil(grid_y /
    axis_size) tile rows from row rank * rows_per; it bins only that slab
    into a capacity // axis_size buffer and composites it with the kernels
    at tile0 = its first tile's grid index. blocks: per-tile pixel blocks
    [rows_per * grid_x, P, ...] (color, depth, flow, acc, final_t, idx);
    total: the slab's true instance count. Needs no process group, so one
    process can run the slabs in turn (composite_projected_slabs)."""
    kcfg = kernel_cfg or KernelConfig()
    if capacity % axis_size:
        raise ValueError(f"sharded capacity {capacity} must divide over axis_size {axis_size}")
    grid_x, grid_y = tile_grid(cam.width, cam.height, kcfg.tile_x, kcfg.tile_y)
    rows_per = -(-grid_y // axis_size)
    row0 = rank * rows_per
    binning = binning_ops.bin_gaussians(proj, grid_x, grid_y, capacity // axis_size,
                                        exact_depth_sort=kcfg.exact_sort,
                                        tight_cull=kcfg.tight_cull, tile_x=kcfg.tile_x,
                                        tile_y=kcfg.tile_y, row0=row0, rows=rows_per,
                                        total_tiles=grid_x * grid_y)
    blocks = composite_blocks(proj, colors, flow_dirs, binning, grid_x=grid_x, bg=bg,
                              max_depth=far, tile_x=kcfg.tile_x, tile_y=kcfg.tile_y,
                              track_idx=track_idx, tile0=row0 * grid_x)
    return blocks, binning.total


def _slab_result(proj: Projected, blocks: comp.RenderOutputs, total_eff, cam: RenderCamera,
                 static_num: int, kcfg: KernelConfig) -> RenderResult:
    """The frame of the slabs' gathered blocks (the padding tiles of the
    last slab dropped)."""
    grid_x, grid_y = tile_grid(cam.width, cam.height, kcfg.tile_x, kcfg.tile_y)

    def timg(arr):
        return comp.tiles_to_image(arr[:grid_x * grid_y], grid_y, grid_x, kcfg.tile_y,
                                   kcfg.tile_x, cam.height, cam.width)

    return RenderResult(render=timg(blocks.color), depth=timg(blocks.depth),
                        opticalflow=timg(blocks.flow), acc=timg(blocks.acc),
                        dominent_idxs=timg(blocks.idx), radii=proj.radius,
                        visibility_filter=proj.radius > 0, static_num=static_num,
                        projected=proj, binning_total=total_eff)


def composite_projected_sharded(proj: Projected, colors, flow_dirs, cam: RenderCamera, *, bg,
                                far: float, capacity: int, group=None, static_num: int = 0,
                                track_idx: bool = False,
                                kernel_cfg: KernelConfig | None = None) -> RenderResult:
    """Tile-sharded compositing over the ranks of process group `group`
    (the mesh's gauss_group; JAX's axis_name): every rank bins and
    composites its slab of tile rows (composite_slab_rank), the tile blocks
    are all-gathered into the frame, the same on every rank.
    binning_total is the worst slab's effective total, group size times the
    largest slab total (a MAX over the group), so the caller's `total <=
    capacity` gate means "every slab fits its buffer" and a capacity grown
    from it fits the fullest slab.

    Gradient: every rank turns the gathered frame into the same loss, so
    each keeps its own blocks' cotangent as it is (collectives.GatherRows,
    replicated). The JAX package's shard_map transposes that gather into a
    sum over the ranks, which scales its render-loss gradients by the group
    size."""
    kcfg = kernel_cfg or KernelConfig()
    size, rank = collectives.group_size(group), collectives.group_rank(group)
    blocks, total = composite_slab_rank(proj, colors, flow_dirs, cam, bg=bg, far=far,
                                        capacity=capacity, rank=rank, axis_size=size,
                                        track_idx=track_idx, kernel_cfg=kcfg)
    gathered = comp.RenderOutputs(*(collectives.gather_rows(a, group, replicated=True)
                                    for a in blocks))
    total_eff = size * collectives.group_max(total, group)
    return _slab_result(proj, gathered, total_eff, cam, static_num, kcfg)


def composite_projected_slabs(proj: Projected, colors, flow_dirs, cam: RenderCamera, *, bg,
                              far: float, capacity: int, axis_size: int, static_num: int = 0,
                              track_idx: bool = False,
                              kernel_cfg: KernelConfig | None = None) -> RenderResult:
    """composite_projected_sharded's frame with the `axis_size` slabs run in
    turn in this process: the same blocks and binning_total as a group of
    that size gives every rank."""
    kcfg = kernel_cfg or KernelConfig()
    parts = [composite_slab_rank(proj, colors, flow_dirs, cam, bg=bg, far=far,
                                 capacity=capacity, rank=r, axis_size=axis_size,
                                 track_idx=track_idx, kernel_cfg=kcfg)
             for r in range(axis_size)]
    blocks = comp.RenderOutputs(*(torch.cat(a, 0) for a in zip(*(b for b, _ in parts))))
    total_eff = axis_size * torch.stack([t for _, t in parts]).amax(0)
    return _slab_result(proj, blocks, total_eff, cam, static_num, kcfg)


# render's optional per-Gaussian inputs: a render given any of them runs eagerly
_PER_GAUSSIAN = ("mean2d_offset", "flow_dirs", "override_color", "subpixel_offset")


def render(cam: RenderCamera, model: GaussianModel, cfg: ModelConfig, *, t, bg,
           mode: int = 0, device=None, **kwargs) -> RenderResult:
    """Render the model at timestamp t on `device` (cuda unless told
    otherwise; the model and camera must already be there). With t a host
    number and bg on the device, the render reads nothing back to the
    host.

    On CUDA a render without gradient (`torch.no_grad`, no stream capture
    under way) of none of the optional per-Gaussian inputs
    (`mean2d_offset`, `flow_dirs`, `override_color`, `subpixel_offset`)
    runs as one CUDA graph (`runtime/graphs.py`, one per card): the first
    call with a key eagerly, the second captures the render and replays it,
    later calls stage t, bg and the camera's tensors into the graph's
    buffers and replay it. The key (`_graph_key`) holds what a capture
    bakes in: the storage of every model tensor, the camera's size, the
    model config, mode and every other option. A replay returns the graph's
    own output tensors, so **the result is overwritten by the next render
    of the same key on that card**: a caller that keeps it past that copies
    it. Every other render runs eagerly and returns fresh tensors."""
    with span("ex4dgs.render"):
        dev = resolve_device(device)
        _on(dev, "the model", model.params["xyz"])
        if (dev.type == "cuda" and not torch.is_grad_enabled()
                and not torch.cuda.is_current_stream_capturing()
                and all(kwargs.get(k) is None for k in _PER_GAUSSIAN)):
            return _graphed_render(cam, model, cfg, t, bg, mode, graphs.card(dev), kwargs)
        return _render_at(cam, model, cfg, t, bg, mode, dev, kwargs)


def _render_at(cam: RenderCamera, model: GaussianModel, cfg: ModelConfig, t, bg, mode: int,
               dev: torch.device, kwargs: dict) -> RenderResult:
    """render's work: the temporal query at t (a host number, or a 0-d
    tensor on dev, as a graph stages it), then render_points."""
    with span("ex4dgs.temporal"):
        pts = point_data_at_t(model, cfg, t, mode=mode)
    return render_points(pts, cam, cfg, bg=bg, device=dev, **kwargs)


def _graph_key(cam: RenderCamera, model: GaussianModel, cfg: ModelConfig, bg, mode: int,
               kwargs: dict) -> tuple:
    """What a capture of render bakes in: the storage of every model
    tensor, the camera's size, the config, mode, every option (the kernel
    config validated, the default for None) and the staged inputs' types
    and shapes; not the values of t, bg and the camera's tensors."""
    opts = {**kwargs, "kernel_cfg": (kwargs.get("kernel_cfg") or KernelConfig()).validate()}
    inputs = [getattr(cam, f) for f in graphs.CAMERA_TENSORS] + [bg]
    return (graphs.state_key(model), cam.width, cam.height, cfg, mode,
            tuple(sorted(opts.items())), tuple((x.device, x.dtype, x.shape) for x in inputs))


def _graphed_render(cam: RenderCamera, model: GaussianModel, cfg: ModelConfig, t, bg,
                    mode: int, dev: torch.device, kwargs: dict) -> RenderResult:
    """render as the graph of its key on the card dev (`graphs.run`): t,
    bg and the camera's tensors are its staged inputs."""
    bg = upload(bg, dev, torch.float32)

    def body(inputs, scalars):
        c = dataclasses.replace(cam, **dict(zip(graphs.CAMERA_TENSORS, inputs)))
        return _render_at(c, model, cfg, scalars[0], inputs[-1], mode, dev, kwargs)

    inputs = [getattr(cam, f) for f in graphs.CAMERA_TENSORS] + [bg]
    return graphs.run("render", dev, _graph_key(cam, model, cfg, bg, mode, kwargs), inputs, [t],
                      {}, body, lambda out: out)


def render4d(cam: RenderCamera, model: Gaussian4DModel, cfg: Model4DConfig, *, t, bg,
             capacity: int | None = None, mean2d_offset=None,
             kernel_cfg: KernelConfig | None = None, device=None) -> RenderResult:
    """Render a 4D Gaussian Splatting model (Yang et al.) at time t (seconds;
    a host number or a 0-d tensor on the device) on `device` (cuda unless
    told otherwise; model and camera must already be there): slice the 4D
    Gaussians at t and colour them by their 4D harmonics
    (`ops/slice4d.py`), project them with 3DGS's uncompensated dilation
    (`cfg.dilation`), then bin and composite as `render` does. Gaussians
    whose marginal in t is at most 0.05, or outside the mask, are invalid:
    they touch no tile, and nothing is compacted, so every shape is fixed.
    Reads nothing back to the host."""
    with span("ex4dgs.render"):
        dev = resolve_device(device)
        _on(dev, "the model", model.params["xyz"])
        _on(dev, "the camera", cam.view)
        kcfg = (kernel_cfg or KernelConfig()).validate()
        P = model.capacity
        if capacity is None:
            capacity = default_capacity(P, cam.width, cam.height, kcfg)
        bg = upload(bg, dev, torch.float32)
        with span("ex4dgs.slice4d"):
            means, cov3d, alpha, rgb, live = slice4d(
                model.params, model.mask, t, cam.campos, model.active_sh_degree,
                model.active_sh_degree_t, span=cfg.time_span)
        with span("ex4dgs.preprocess"):
            proj = project_gaussians(means, cov3d, alpha, cam.arrays, width=cam.width,
                                     height=cam.height, tan_fovx=cam.tan_fovx,
                                     tan_fovy=cam.tan_fovy, kernel_size=cfg.dilation,
                                     min_depth=cfg.near, max_depth=cfg.far,
                                     mean2d_ndc_offset=mean2d_offset, tile_x=kcfg.tile_x,
                                     tile_y=kcfg.tile_y, compensate=False)
            proj = _masked(proj, live)
        flow = torch.zeros((P, 3), dtype=torch.float32, device=dev)
        return composite_projected(proj, rgb, flow, cam, bg=bg, far=cfg.far, capacity=capacity,
                                   track_idx=False, kernel_cfg=kcfg)


def render_deform(cam: RenderCamera, model: DeformModel, cfg: ModelDeformConfig, *, t, bg,
                  capacity: int | None = None, mean2d_offset=None,
                  kernel_cfg: KernelConfig | None = None, device=None) -> RenderResult:
    """Render a 4D-GS model (Wu et al.) at time t (the source's normalised
    time in [0, 1); a host number or a 0-d tensor on the device) on
    `device` (cuda unless told otherwise; model and camera must already be
    there): deform the canonical Gaussians by the HexPlane field and its
    MLP (`models/deform.py`), apply the activations (exp of the scales,
    the quaternion normalised, sigmoid of the opacity), colour the deformed
    SH at degree cfg.sh_degree from the camera centre to the deformed
    mean, project with 3DGS's uncompensated dilation (`cfg.dilation`),
    then bin and composite as `render` does. Rows outside the mask are
    invalid. Reads nothing back to the host."""
    with span("ex4dgs.render"):
        dev = resolve_device(device)
        _on(dev, "the model", model.params["xyz"])
        _on(dev, "the camera", cam.view)
        kcfg = (kernel_cfg or KernelConfig()).validate()
        P = model.capacity
        if capacity is None:
            capacity = default_capacity(P, cam.width, cam.height, kcfg)
        bg = upload(bg, dev, torch.float32)
        means, scaling, rotation, opacity, sh = deform(model.params, model.aabb, t, cfg)
        with span("ex4dgs.preprocess"):
            quat = rotation / torch.linalg.norm(rotation, dim=-1, keepdim=True)
            cov3d = cov3d_from_scaling_rotation(torch.exp(scaling), quat)
            rgb = sh_to_rgb(cfg.sh_degree, sh, means, cam.campos)
            proj = project_gaussians(means, cov3d, torch.sigmoid(opacity[:, 0]), cam.arrays,
                                     width=cam.width, height=cam.height, tan_fovx=cam.tan_fovx,
                                     tan_fovy=cam.tan_fovy, kernel_size=cfg.dilation,
                                     min_depth=cfg.near, max_depth=cfg.far,
                                     mean2d_ndc_offset=mean2d_offset, tile_x=kcfg.tile_x,
                                     tile_y=kcfg.tile_y, compensate=False)
            proj = _masked(proj, model.mask)
        flow = torch.zeros((P, 3), dtype=torch.float32, device=dev)
        return composite_projected(proj, rgb, flow, cam, bg=bg, far=cfg.far, capacity=capacity,
                                   track_idx=False, kernel_cfg=kcfg)


def default_capacity(num_points: int, width: int, height: int,
                     kernel_cfg: KernelConfig | None = None) -> int:
    """Instance-buffer size: a generous tiles-per-splat allowance, rounded
    to a bucket."""
    kcfg = kernel_cfg or KernelConfig()
    grid_x, grid_y = tile_grid(width, height, kcfg.tile_x, kcfg.tile_y)
    return binning_ops.required_capacity(max(8 * num_points, 64 * grid_x * grid_y))
