"""Per-Gaussian preprocessing: frustum culling, projection, EWA covariance,
conic, radius and the tile rectangle each splat touches.

Counterpart of `ex4dgs_tpu/ops/projection.py`. Binning is a function of
`rect_min`, `rect_max` and `tiles_touched`, so their float inputs are
computed with the JAX package's exact operation order, and the float -> int
conversions reproduce XLA's (truncation toward zero; NaN -> 0; out-of-range
values saturate before the clip to the grid).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .math3d import cov3d_from_scaling_rotation, ewa_project_cov, ndc2pix


class CameraArrays(NamedTuple):
    """Per-camera tensors consumed by the rasterizer (all float32)."""

    view: torch.Tensor  # [4,4] world->camera
    proj: torch.Tensor  # [4,4] full projection = P @ view
    campos: torch.Tensor  # [3] camera centre in world space


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities."""

    xy: torch.Tensor  # [P,2] pixel-space mean
    depth: torch.Tensor  # [P] camera-space z
    conic: torch.Tensor  # [P,3] inverse dilated 2D covariance (a,b,c)
    opacity: torch.Tensor  # [P] opacity * low-pass compensation coef
    radius: torch.Tensor  # [P] int32 screen radius (0 => culled)
    rect_min: torch.Tensor  # [P,2] int32 tile rect (x,y), clamped to grid
    rect_max: torch.Tensor  # [P,2] int32 (exclusive)
    tiles_touched: torch.Tensor  # [P] int32
    valid: torch.Tensor  # [P] bool


def tile_grid(width: int, height: int, tile_x: int = 32, tile_y: int = 16) -> tuple[int, int]:
    return (width + tile_x - 1) // tile_x, (height + tile_y - 1) // tile_y


_I32_MAX_F = 2147483520.0  # largest float32 below 2^31


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: truncate toward zero, NaN -> 0,
    saturate at the int32 range (a plain `.to(torch.int32)` is undefined
    out of range)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=3e9, neginf=-3e9)
    r = x.clamp(-2147483648.0, _I32_MAX_F).to(torch.int32)
    return torch.where(x >= 2147483648.0, torch.full_like(r, 2**31 - 1), r)


def project_gaussians(means3d, cov3d, opacities, cam: CameraArrays, *, width: int,
                      height: int, tan_fovx, tan_fovy, kernel_size: float,
                      min_depth: float = 0.2, max_depth: float = 100.0,
                      mean2d_ndc_offset=None, tile_x: int = 32,
                      tile_y: int = 16, compensate: bool = True) -> Projected:
    """Project Gaussians to screen space. `mean2d_ndc_offset` (zeros [P,3])
    is added to the NDC mean, the hook whose gradient trains densification.
    compensate False dilates the 2D covariance by kernel_size without
    scaling the opacity (3DGS's rasterizer); True is Ex4DGS's compensated
    low-pass filter."""
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    def affine(row):
        return row[0] * mx + row[1] * my + row[2] * mz + row[3]

    p_view_z = affine(cam.view[2])
    ph_x = affine(cam.proj[0])
    ph_y = affine(cam.proj[1])
    ph_w = affine(cam.proj[3])
    p_w = 1.0 / (ph_w + 1e-7)
    px_ndc = ph_x * p_w
    py_ndc = ph_y * p_w
    if mean2d_ndc_offset is not None:
        px_ndc = px_ndc + mean2d_ndc_offset[:, 0]
        py_ndc = py_ndc + mean2d_ndc_offset[:, 1]

    depth = p_view_z
    in_frustum = (
        (depth > min_depth)
        & (depth <= max_depth)
        & (torch.abs(px_ndc) <= 1.3)
        & (torch.abs(py_ndc) <= 1.3)
    )

    p_view = torch.stack([affine(cam.view[0]), affine(cam.view[1]), p_view_z], -1)
    cov2d, coef = ewa_project_cov(p_view, cov3d, cam.view[:3, :3], focal_x, focal_y,
                                  tan_fovx, tan_fovy, kernel_size, compensate)
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    det_inv = 1.0 / safe_det
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0)))
    # Opacity-aware extent: compositing drops alpha < 1/255, so a splat's
    # support ends at sigma*sqrt(2 ln(255 alpha)); the rect is the per-axis
    # minimum of that ellipse's bbox and the 3-sigma square.
    alpha_eff = torch.clamp_min(opacities * coef, 1e-12)
    support = torch.sqrt(2.0 * torch.clamp_min(torch.log(255.0 * alpha_eff), 1e-2))
    radius3 = 3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0))
    rect_rx = torch.ceil(torch.minimum(support * torch.sqrt(torch.clamp_min(a, 0.0)), radius3))
    rect_ry = torch.ceil(torch.minimum(support * torch.sqrt(torch.clamp_min(c, 0.0)), radius3))

    pix_x = ndc2pix(px_ndc, width)
    pix_y = ndc2pix(py_ndc, height)
    xy = torch.stack([pix_x, pix_y], dim=-1)

    grid_x, grid_y = tile_grid(width, height, tile_x, tile_y)
    # floor(v / tile) + 1 is the exact exclusive bound of the last covered
    # pixel floor(v); the lower bound truncates, as the reference's getRect.
    rmin_x = _to_i32((pix_x - rect_rx) / tile_x).clamp(0, grid_x)
    rmin_y = _to_i32((pix_y - rect_ry) / tile_y).clamp(0, grid_y)
    rmax_x = (_to_i32(torch.floor((pix_x + rect_rx) / tile_x)) + 1).clamp(0, grid_x)
    rmax_y = (_to_i32(torch.floor((pix_y + rect_ry) / tile_y)) + 1).clamp(0, grid_y)
    tiles_touched = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    valid = in_frustum & det_ok & (tiles_touched > 0)
    tiles_touched = torch.where(valid, tiles_touched, torch.zeros_like(tiles_touched))
    radius = _to_i32(torch.where(valid, radius_f, torch.zeros_like(radius_f)))

    return Projected(
        xy=xy,
        depth=depth,
        conic=conic,
        opacity=opacities * coef,
        radius=radius,
        rect_min=torch.stack([rmin_x, rmin_y], -1),
        rect_max=torch.stack([rmax_x, rmax_y], -1),
        tiles_touched=tiles_touched,
        valid=valid,
    )


def compute_cov3d(scales, rotations, scale_modifier: float = 1.0):
    return cov3d_from_scaling_rotation(scales, rotations, scale_modifier)


def mark_visible(means3d, cam: CameraArrays, min_depth: float = 0.2,
                 max_depth: float = 100.0) -> torch.Tensor:
    """[P] bool: the standalone frustum-visibility test
    (rasterizer_impl.cu:markVisible; JAX's projection.py:191)."""
    P = means3d.shape[0]
    hom = torch.cat([means3d, torch.ones((P, 1), dtype=means3d.dtype, device=means3d.device)],
                    dim=1)
    p_view = hom @ cam.view[:3].T
    p_hom = hom @ cam.proj.T
    p_proj = p_hom[:, :3] / (p_hom[:, 3:4] + 1e-7)
    depth = p_view[:, 2]
    return ((depth > min_depth) & (depth <= max_depth)
            & (torch.abs(p_proj[:, 0]) <= 1.3) & (torch.abs(p_proj[:, 1]) <= 1.3))
