"""Slicing 4D Gaussians at a time t, and their colour by 4D spherindrical
harmonics (4D Gaussian Splatting, Yang et al., ICLR 2024): the kernel pair
`csrc/slice4d_fwd.cu` / `csrc/slice4d_bwd.cu`, their plain versions, and
the autograd function the render calls.

Per Gaussian, from its raw parameters (PARAMS), the active mask, the time
t, the camera centre, the time span l and the active SH degrees in space
and time:

  R     = M_l(q_l / |q_l|) M_r(q_r / |q_r|)                  4D rotation
  Sigma = R diag(exp(s))^2 R^T
  v     = Sigma_tt,  c = Sigma_{xyz,t},  dt = t - mu_t
  cov3d = Sigma_xyz - c c^T / v                              packed xx xy xz yy yz zz
  mean  = mu_xyz + c dt / v
  alpha = sigmoid(o) exp(-dt^2 / (2 v))                      opacity x the marginal in t
  rgb   = max(sum_k cos(2 pi k (mu_t - t) / l) SH(d) . f[16k : 16k + 16] + 0.5, 0)
  live  = mask & (exp(-dt^2 / (2 v)) > 0.05)

with d the unit vector from the camera centre to the sliced mean, SH the
3DGS real basis up to the active degree and k up to the active time
degree. The harmonics' time argument mu_t - t is detached, as in the
source. The backward returns the gradient of every parameter from the
cotangents of mean, cov3d, alpha and rgb, each term differentiated by hand
(`slice4d_bwd_plain`; the kernel computes the same terms).

On CPU tensors `Slice4D` runs the plain versions; on CUDA tensors it
launches the kernels (`kernels.slice4d_fwd`, `kernels.slice4d_bwd`) and
raises where they cannot run. Float32 throughout.
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from .math3d import SH_C0, SH_C1, SH_C2, SH_C3

PARAMS = ("xyz", "t", "scaling", "scaling_t", "rotation", "rotation_r", "opacity", "f_dc",
          "f_rest")
MARGINAL_MIN = 0.05  # the source's renderer passes on Gaussians above this marginal
BAND = 16  # basis functions of SH degree 3: one time band of feature rows
# The kernels against the plain versions, in float32: the forward to
# SLICE_RTOL of each output's largest value (a few ulps, 6e-8, amplified by
# the conditional's cancellation, Sigma_xyz less c c^T / v, up to ~100x at
# the floor of Sigma_tt); each gradient to SLICE_BWD_RTOL of its leaf's
# largest (it sums the same terms in another order, and the conditional's
# 1 / v^2 terms amplify the rounding at the floor). bfloat16 (ulp 4e-3)
# misses either by two orders.
SLICE_RTOL = 2e-5
SLICE_BWD_RTOL = 1e-4


def _rotation(ql, qr):
    """(R [P, 4, 4], M_l, M_r, unit q_l, unit q_r, |q_l|, |q_r|)."""
    nl = torch.linalg.norm(ql, dim=-1, keepdim=True)
    nr = torch.linalg.norm(qr, dim=-1, keepdim=True)
    ul, ur = ql / nl, qr / nr
    a, b, c, d = ul.unbind(-1)
    p, q, r, s = ur.unbind(-1)
    ml = torch.stack([a, -b, -c, -d, b, a, -d, c, c, d, a, -b, d, -c, b, a], -1).view(-1, 4, 4)
    mr = torch.stack([p, q, r, s, -q, p, -s, r, -r, s, p, -q, -s, -r, q, p], -1).view(-1, 4, 4)
    return ml @ mr, ml, mr, ul, ur, nl, nr


def sh_basis(d, degree):
    """[P, 16] the 3DGS real SH basis at unit directions d [P, 3], zero past
    `degree` (an int or a 0-d tensor), and its Jacobian [P, 16, 3]."""
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    b = [SH_C0 * one, -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
         SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
         SH_C2[4] * (xx - yy),
         SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z, SH_C3[2] * y * (4 * zz - xx - yy),
         SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
         SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    j = [(zero, zero, zero), (zero, -SH_C1 * one, zero), (zero, zero, SH_C1 * one),
         (-SH_C1 * one, zero, zero),
         (SH_C2[0] * y, SH_C2[0] * x, zero), (zero, SH_C2[1] * z, SH_C2[1] * y),
         (-2 * SH_C2[2] * x, -2 * SH_C2[2] * y, 4 * SH_C2[2] * z),
         (SH_C2[3] * z, zero, SH_C2[3] * x), (2 * SH_C2[4] * x, -2 * SH_C2[4] * y, zero),
         (6 * SH_C3[0] * x * y, SH_C3[0] * (3 * xx - 3 * yy), zero),
         (SH_C3[1] * y * z, SH_C3[1] * x * z, SH_C3[1] * x * y),
         (-2 * SH_C3[2] * x * y, SH_C3[2] * (4 * zz - xx - 3 * yy), 8 * SH_C3[2] * y * z),
         (-6 * SH_C3[3] * x * z, -6 * SH_C3[3] * y * z, SH_C3[3] * (6 * zz - 3 * xx - 3 * yy)),
         (SH_C3[4] * (4 * zz - 3 * xx - yy), -2 * SH_C3[4] * x * y, 8 * SH_C3[4] * x * z),
         (2 * SH_C3[5] * x * z, -2 * SH_C3[5] * y * z, SH_C3[5] * (xx - yy)),
         (SH_C3[6] * (3 * xx - 3 * yy), -6 * SH_C3[6] * x * y, zero)]
    on = (torch.arange(BAND, device=d.device) < (degree + 1) ** 2).to(d.dtype)
    basis = torch.stack(b, -1) * on
    jac = torch.stack([torch.stack(r, -1) for r in j], -2) * on[:, None]
    return basis, jac


def _time_weights(mu_t, t, span: float, degree_t, bands: int):
    """[P, bands] cos(2 pi k (mu_t - t) / l) for k < bands, zero past the
    active time degree."""
    k = torch.arange(bands, device=mu_t.device, dtype=mu_t.dtype)
    w = torch.cos(2.0 * math.pi * k * (mu_t - t) / span)
    return w * (k <= degree_t).to(mu_t.dtype)


def _features(f_dc, f_rest):
    """[P, bands, 16, 3] features by time band."""
    f = torch.cat([f_dc, f_rest], 1)
    return f.view(f.shape[0], -1, BAND, 3)


def _forward_parts(xyz, mu_t, scaling, scaling_t, rotation, rotation_r, t):
    rot, ml, mr, ul, ur, nl, nr = _rotation(rotation, rotation_r)
    scale = torch.exp(torch.cat([scaling, scaling_t], -1))
    var = scale * scale  # [P, 4] the diagonal D
    sigma = (rot * var[:, None, :]) @ rot.transpose(1, 2)
    c, v = sigma[:, :3, 3], sigma[:, 3, 3]
    dt = t - mu_t[:, 0]
    mean = xyz + c * (dt / v)[:, None]
    marg = torch.exp(-0.5 * dt * dt / v)
    return dict(rot=rot, ml=ml, mr=mr, ul=ul, ur=ur, nl=nl, nr=nr, var=var, sigma=sigma, c=c,
                v=v, dt=dt, mean=mean, marg=marg)


_PACK = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def slice4d_plain(xyz, mu_t, scaling, scaling_t, rotation, rotation_r, opacity, f_dc, f_rest,
                  mask, t, campos, degree, degree_t, *, span: float):
    """The forward kernel's outputs in plain torch: (mean [P, 3], cov3d
    [P, 6], alpha [P], rgb [P, 3], live [P] bool). t, degree and degree_t
    are numbers or 0-d tensors."""
    f = _forward_parts(xyz, mu_t, scaling, scaling_t, rotation, rotation_r, t)
    sig, c, v = f["sigma"], f["c"], f["v"]
    cov = torch.stack([sig[:, i, j] - c[:, i] * c[:, j] / v for i, j in _PACK], -1)
    alpha = torch.sigmoid(opacity[:, 0]) * f["marg"]
    feats = _features(f_dc, f_rest)
    d = f["mean"] - campos
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    basis, _ = sh_basis(d, degree)
    w = _time_weights(mu_t, t, span, degree_t, feats.shape[1])
    rgb = torch.clamp_min(torch.einsum("pk,pj,pkjc->pc", w, basis, feats) + 0.5, 0.0)
    live = mask & (f["marg"] > MARGINAL_MIN)
    return f["mean"], cov, alpha, rgb, live


def _quat_grads(g_m, signs):
    """The gradient of a quaternion from that of its 4x4 matrix, given for
    each component the (row, col, sign) entries where it appears."""
    return torch.stack([sum(s * g_m[:, i, j] for i, j, s in entries) for entries in signs], -1)


_ML_SIGNS = ([(0, 0, 1), (1, 1, 1), (2, 2, 1), (3, 3, 1)],
             [(0, 1, -1), (1, 0, 1), (2, 3, -1), (3, 2, 1)],
             [(0, 2, -1), (1, 3, 1), (2, 0, 1), (3, 1, -1)],
             [(0, 3, -1), (1, 2, -1), (2, 1, 1), (3, 0, 1)])
_MR_SIGNS = ([(0, 0, 1), (1, 1, 1), (2, 2, 1), (3, 3, 1)],
             [(0, 1, 1), (1, 0, -1), (2, 3, -1), (3, 2, 1)],
             [(0, 2, 1), (1, 3, 1), (2, 0, -1), (3, 1, -1)],
             [(0, 3, 1), (1, 2, -1), (2, 1, 1), (3, 0, -1)])


def slice4d_bwd_plain(xyz, mu_t, scaling, scaling_t, rotation, rotation_r, opacity, f_dc,
                      f_rest, t, campos, degree, degree_t, g_mean, g_cov, g_alpha, g_rgb, *,
                      span: float):
    """The backward kernel's gradients in plain torch, one per parameter in
    PARAMS order, from the cotangents of mean [P, 3], cov3d [P, 6], alpha
    [P] and rgb [P, 3]."""
    f = _forward_parts(xyz, mu_t, scaling, scaling_t, rotation, rotation_r, t)
    c, v, dt, marg = f["c"], f["v"], f["dt"], f["marg"]
    feats = _features(f_dc, f_rest)
    bands = feats.shape[1]
    # colour: rgb = max(sum_kj w_k B_j f_kj + 0.5, 0); the clamp passes
    # the gradient where its input is >= 0
    dirv = f["mean"] - campos
    n = torch.linalg.norm(dirv, dim=-1, keepdim=True)
    d = dirv / n
    basis, jac = sh_basis(d, degree)
    w = _time_weights(mu_t, t, span, degree_t, bands)
    eff = torch.einsum("pk,pkjc->pjc", w, feats)  # F_j = sum_k w_k f_kj
    pre = torch.einsum("pj,pjc->pc", basis, eff) + 0.5
    g_pre = torch.where(pre >= 0, g_rgb, torch.zeros_like(g_rgb))
    g_feat = torch.einsum("pk,pj,pc->pkjc", w, basis, g_pre).reshape(feats.shape[0], -1, 3)
    g_basis = torch.einsum("pjc,pc->pj", eff, g_pre)
    g_d = torch.einsum("pj,pjx->px", g_basis, jac)
    g_dir = (g_d - d * (d * g_d).sum(-1, keepdim=True)) / n
    g_mean_all = g_mean + g_dir
    # alpha = sigmoid(o) m, m = exp(-dt^2 / 2v)
    sg = torch.sigmoid(opacity[:, 0])
    g_o = g_alpha * marg * sg * (1.0 - sg)
    g_m = g_alpha * sg * marg  # times d(-dt^2 / 2v)
    # mean = xyz + c dt / v
    h = (g_mean_all * c).sum(-1)
    g_c = g_mean_all * (dt / v)[:, None]
    g_mu_t = -h / v + g_m * dt / v
    g_v = -h * dt / (v * v) + g_m * 0.5 * dt * dt / (v * v)
    # cov3d = Sigma_xyz - c c^T / v; Gs the symmetric gradient of Sigma_xyz
    gs = torch.zeros((xyz.shape[0], 3, 3), dtype=xyz.dtype, device=xyz.device)
    for col, (i, j) in enumerate(_PACK):
        if i == j:
            gs[:, i, i] = g_cov[:, col]
        else:
            gs[:, i, j] = gs[:, j, i] = 0.5 * g_cov[:, col]
    gsc = torch.einsum("pij,pj->pi", gs, c)
    g_c = g_c - 2.0 * gsc / v[:, None]
    g_v = g_v + (c * gsc).sum(-1) / (v * v)
    # Sigma = R D R^T, G its symmetric gradient
    g_sig = torch.zeros((xyz.shape[0], 4, 4), dtype=xyz.dtype, device=xyz.device)
    g_sig[:, :3, :3] = gs
    g_sig[:, :3, 3] = g_sig[:, 3, :3] = 0.5 * g_c
    g_sig[:, 3, 3] = g_v
    rot, var = f["rot"], f["var"]
    g_rot = 2.0 * (g_sig @ rot) * var[:, None, :]
    g_var = torch.einsum("pik,pij,pjk->pk", rot, g_sig, rot)
    g_scale = 2.0 * g_var * var  # D_k = exp(2 s_k)
    # R = M_l M_r, then the quaternions' normalisation
    g_ml = g_rot @ f["mr"].transpose(1, 2)
    g_mr = f["ml"].transpose(1, 2) @ g_rot
    g_ul, g_ur = _quat_grads(g_ml, _ML_SIGNS), _quat_grads(g_mr, _MR_SIGNS)
    g_ql = (g_ul - f["ul"] * (f["ul"] * g_ul).sum(-1, keepdim=True)) / f["nl"]
    g_qr = (g_ur - f["ur"] * (f["ur"] * g_ur).sum(-1, keepdim=True)) / f["nr"]
    return (g_mean_all, g_mu_t[:, None], g_scale[:, :3], g_scale[:, 3:], g_ql, g_qr,
            g_o[:, None], g_feat[:, :1], g_feat[:, 1:])


def _dev_scalar(x, dev, dtype):
    return x.to(device=dev, dtype=dtype) if isinstance(x, torch.Tensor) else torch.full(
        (), x, dtype=dtype, device=dev)


class Slice4D(torch.autograd.Function):
    """The slicing and the 4D harmonics as one autograd node: the kernels
    on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, xyz, mu_t, scaling, scaling_t, rotation, rotation_r, opacity, f_dc, f_rest,
                mask, t, campos, degree, degree_t, span):
        params = (xyz, mu_t, scaling, scaling_t, rotation, rotation_r, opacity, f_dc, f_rest)
        ctx.save_for_backward(*params, t, campos, degree, degree_t)
        ctx.span = span
        if xyz.device.type == "cpu":
            out = slice4d_plain(*params, mask, t, campos, degree, degree_t, span=span)
        else:
            out = kernels.slice4d_fwd(*params, mask, t, campos, degree, degree_t, span=span)
        ctx.mark_non_differentiable(out[4])
        return out

    @staticmethod
    def backward(ctx, g_mean, g_cov, g_alpha, g_rgb, _g_live):
        *params, t, campos, degree, degree_t = ctx.saved_tensors
        cots = [g.contiguous() for g in (g_mean, g_cov, g_alpha, g_rgb)]
        if params[0].device.type == "cpu":
            grads = slice4d_bwd_plain(*params, t, campos, degree, degree_t, *cots,
                                      span=ctx.span)
        else:
            grads = kernels.slice4d_bwd(*params, t, campos, degree, degree_t, *cots,
                                        span=ctx.span)
        return (*grads, None, None, None, None, None, None)


def slice4d(params: dict, mask, t, campos, degree, degree_t, *, span: float):
    """(mean, cov3d, alpha, rgb, live) of the Gaussians `params` (PARAMS by
    name) at time t, seen from campos; t, degree and degree_t are numbers or
    0-d tensors (on the params' device for the kernels)."""
    dev = params["xyz"].device
    t = _dev_scalar(t, dev, torch.float32)
    degree = _dev_scalar(degree, dev, torch.int32)
    degree_t = _dev_scalar(degree_t, dev, torch.int32)
    return Slice4D.apply(*(params[k] for k in PARAMS), mask, t, campos, degree, degree_t,
                         float(span))
