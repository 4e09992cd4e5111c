"""Core 3D math: quaternions, covariances, camera matrices, spherical harmonics.

Counterpart of `ex4dgs_tpu/ops/math3d.py`. Matrices are mathematical (they
act on column vectors): `view` is the 4x4 world->camera matrix, `proj` the
full clip projection P @ view. Every expression keeps the JAX package's
operation order, so float32 results agree to the last bit wherever both
sides use the same IEEE operations (projection rects depend on it).
"""
from __future__ import annotations

import math

import numpy as np
import torch

# Real spherical-harmonic constants, degrees 0..3.
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def quat_to_rotmat(q: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]."""
    if normalize:
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y)], -1)
    row1 = torch.stack(
        [2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x)], -1)
    row2 = torch.stack(
        [2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def cov3d_from_scaling_rotation(scaling: torch.Tensor, rotation: torch.Tensor,
                                scale_modifier: float = 1.0) -> torch.Tensor:
    """World covariance R S^2 R^T packed as (xx, xy, xz, yy, yz, zz). The
    quaternion is used unnormalized, as the reference rasterizer does."""
    r, x, y, z = (rotation[..., i] for i in range(4))
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - r * z)
    r02 = 2.0 * (x * z + r * y)
    r10 = 2.0 * (x * y + r * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - r * x)
    r20 = 2.0 * (x * z - r * y)
    r21 = 2.0 * (y * z + r * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s0 = scale_modifier * scaling[..., 0]
    s1 = scale_modifier * scaling[..., 1]
    s2 = scale_modifier * scaling[..., 2]
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    return torch.stack([
        m00 * m00 + m01 * m01 + m02 * m02,
        m00 * m10 + m01 * m11 + m02 * m12,
        m00 * m20 + m01 * m21 + m02 * m22,
        m10 * m10 + m11 * m11 + m12 * m12,
        m10 * m20 + m11 * m21 + m12 * m22,
        m20 * m20 + m21 * m21 + m22 * m22,
    ], dim=-1)


def ewa_project_cov(mean_cam, cov3d, view_rot, focal_x, focal_y, tan_fovx,
                    tan_fovy, kernel_size: float, compensate: bool = True):
    """EWA 2D covariance with the low-pass dilation.

    Returns (cov2d [..., 3] = dilated (a, b, c), coef [...] = the opacity
    compensation sqrt(det0/det1), 0 where degenerate; with compensate False,
    3DGS's dilation alone, coef 1). Includes the 1.3*tanfov clamp of the
    Jacobian's linearization point."""
    tx, ty, tz = mean_cam[..., 0], mean_cam[..., 1], mean_cam[..., 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2
    w = view_rot
    t00 = j00 * w[0, 0] + j02 * w[2, 0]
    t01 = j00 * w[0, 1] + j02 * w[2, 1]
    t02 = j00 * w[0, 2] + j02 * w[2, 2]
    t10 = j11 * w[1, 0] + j12 * w[2, 0]
    t11 = j11 * w[1, 1] + j12 * w[2, 1]
    t12 = j11 * w[1, 2] + j12 * w[2, 2]
    vxx, vxy, vxz, vyy, vyz, vzz = (cov3d[..., i] for i in range(6))
    a = (
        t00 * t00 * vxx + t01 * t01 * vyy + t02 * t02 * vzz
        + 2.0 * (t00 * t01 * vxy + t00 * t02 * vxz + t01 * t02 * vyz)
    )
    b = (
        t00 * t10 * vxx + t01 * t11 * vyy + t02 * t12 * vzz
        + (t00 * t11 + t01 * t10) * vxy
        + (t00 * t12 + t02 * t10) * vxz
        + (t01 * t12 + t02 * t11) * vyz
    )
    c = (
        t10 * t10 * vxx + t11 * t11 * vyy + t12 * t12 * vzz
        + 2.0 * (t10 * t11 * vxy + t10 * t12 * vxz + t11 * t12 * vyz)
    )
    if not compensate:
        return torch.stack([a + kernel_size, b, c + kernel_size], dim=-1), torch.ones_like(a)
    # the compensated path's operations stay in this order: autograd sums a
    # tensor's gradients in the order its uses were recorded
    det0 = torch.clamp_min(a * c - b * b, 1e-6)
    det1 = torch.clamp_min((a + kernel_size) * (c + kernel_size) - b * b, 1e-6)
    coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)
    coef = torch.where((det0 <= 1e-6) | (det1 <= 1e-6), torch.zeros_like(coef), coef)
    cov2d = torch.stack([a + kernel_size, b, c + kernel_size], dim=-1)
    return cov2d, coef


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH colors (deg <= 3) before the +0.5 shift. sh [..., K, 3],
    dirs [..., 3] unit vectors."""
    result = SH_C0 * sh[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (
            result - SH_C1 * y * sh[..., 1, :] + SH_C1 * z * sh[..., 2, :]
            - SH_C1 * x * sh[..., 3, :]
        )
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh[..., 4, :]
                + SH_C2[1] * yz * sh[..., 5, :]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + SH_C2[3] * xz * sh[..., 7, :]
                + SH_C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if deg > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                    + SH_C3[1] * xy * z * sh[..., 10, :]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
                )
    return result


def sh_to_rgb(deg: int, sh: torch.Tensor, means: torch.Tensor,
              campos: torch.Tensor) -> torch.Tensor:
    """SH -> RGB shifted by 0.5 and clamped at 0, as the rasterizer does."""
    dirs = means - campos
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.clamp_min(eval_sh(deg, sh, dirs) + 0.5, 0.0)


def rgb_to_sh0(rgb):
    """Inverse of the DC shift: (rgb - 0.5) / SH_C0."""
    return (rgb - 0.5) / SH_C0


def sh0_to_rgb(sh):
    """The DC shift: sh * SH_C0 + 0.5."""
    return sh * SH_C0 + 0.5


# Camera matrices: host-side numpy, tiny and built once per camera.

def world_to_view(R: np.ndarray, t: np.ndarray, translate=None,
                  scale: float = 1.0) -> np.ndarray:
    """World->camera 4x4 from COLMAP-style (R camera-to-world rotation, t
    world->camera translation), with optional recentring/rescaling."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                      cx: float = 0.0, cy: float = 0.0) -> np.ndarray:
    """Perspective projection, optionally off-centre (cx, cy in [-0.5, 0.5]),
    with the two P[2,2] conventions of the centred and the CV variant."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right
    off_center = cx != 0.0 or cy != 0.0
    if off_center:
        dx = (2 * tan_half_fovx * znear) * cx
        dy = (2 * tan_half_fovy * znear) * cy
        left += dx
        right += dx
        top += dy
        bottom += dy
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    if off_center:
        P[2, 2] = (zfar + znear) / (zfar - znear)
    else:
        P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P.astype(np.float32)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def ndc2pix(v, size):
    """NDC [-1, 1] -> pixel-centre coordinates."""
    return ((v + 1.0) * size - 1.0) * 0.5


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))
