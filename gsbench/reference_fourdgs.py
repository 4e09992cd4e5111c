"""The plain reference of 4D Gaussian Splatting (Yang et al., ICLR 2024;
github.com/fudan-zvg/4d-gaussian-splatting, its dynerf recipe): a frame and
a training step of several views, in plain PyTorch, written from the
paper's equations and imported by nothing of the program.

It computes in any floating dtype (float64 for the reference, bfloat16 for
the control), with TF32 off, from the parameters under the source's names
(PARAMS), the host camera matrices, the times in seconds, the backgrounds
and the images. Everything the program derives is worked out here again:

  * a Gaussian's 4D rotation is M_l(q_l) M_r(q_r) of its unit quaternions,
    as 4x4 matrices; its covariance (R diag(exp s))(R diag(exp s))^T;
  * sliced at t it is the conditional Gaussian: covariance Sigma_xyz -
    Sigma_xyz,t Sigma_xyz,t^T / Sigma_tt, mean mu_xyz + Sigma_xyz,t (t -
    mu_t) / Sigma_tt, opacity sigmoid(o) times the marginal exp(-(t -
    mu_t)^2 / 2 Sigma_tt); a Gaussian whose marginal is at most 0.05 is not
    rendered;
  * its colour is max(sum_k cos(2 pi k (mu_t - t) / l) SH(d) . f_k + 0.5, 0)
    with f_k the 16 feature rows of time band k, d the unit vector from the
    camera centre to the sliced mean and (mu_t - t) detached; SH is the
    real basis by its polynomials, up to the active degree in space and
    in time;
  * the projection is 3DGS's: EWA with the Jacobian's 1.3 tan(fov) clamp
    and a 2D dilation added to the diagonal, no opacity compensation; the
    frustum keeps depth in (near, far] and |NDC| <= 1.3;
  * screen-space splats are binned and composited as `gsbench/reference.py`
    composites (tile lists, front-to-back blending, alpha clamp 0.99, floor
    1/255, stop at transmittance 1e-4), with the exact depth order;
  * a step renders each view at its own time, takes the mean of the views'
    (1 - l) L1 + l (1 - SSIM) losses and one gradient, then Adam (betas
    0.9, 0.999, the recipe's eps) on the active rows at the scheduled rates,
    and the densification statistics of the batch.

Departures from the source, each named:
  * the tile rectangle is the least of the 3-sigma square and the box of
    the ellipse where alpha falls to 1/255 (the program's); it drops only
    pairs with alpha under 1/255, which the compositing skips, so the
    image is the same;
  * the statistics take the screen-space mean gradient summed over the
    views and count a batch once where some view saw the Gaussian; the
    source's time-gradient accumulator is left out;
  * t's learning rate follows the position schedule;
  * no densification events (clone, split, prune, opacity reset): the
    step alone.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gsbench import reference as R

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PARAMS = ("xyz", "t", "scaling", "scaling_t", "rotation", "rotation_r", "opacity", "f_dc",
          "f_rest")
STATS = ("max_radii2D", "xyz_gradient_accum", "denom")
MARGINAL_MIN = 0.05
BETA1, BETA2 = 0.9, 0.999
SH_C0 = R.SH_C0
SH_C1 = R.SH_C1
SH_C2 = R.SH_C2
SH_C3 = R.SH_C3


# ---------------------------------------------------------------------------
# 4D Gaussians sliced at t
# ---------------------------------------------------------------------------

def rotation_4d(ql, qr):
    """[P, 4, 4] M_l(q_l / |q_l|) M_r(q_r / |q_r|)."""
    a, b, c, d = (ql / torch.linalg.norm(ql, dim=-1, keepdim=True)).unbind(-1)
    p, q, r, s = (qr / torch.linalg.norm(qr, dim=-1, keepdim=True)).unbind(-1)
    m_l = torch.stack([torch.stack([a, -b, -c, -d], -1), torch.stack([b, a, -d, c], -1),
                       torch.stack([c, d, a, -b], -1), torch.stack([d, -c, b, a], -1)], -2)
    m_r = torch.stack([torch.stack([p, q, r, s], -1), torch.stack([-q, p, -s, r], -1),
                       torch.stack([-r, s, p, -q], -1), torch.stack([-s, -r, q, p], -1)], -2)
    return m_l @ m_r


def covariance_4d(p: dict):
    """[P, 4, 4] L L^T with L = R diag(exp(s))."""
    scale = torch.exp(torch.cat([p["scaling"], p["scaling_t"]], -1))
    L = rotation_4d(p["rotation"], p["rotation_r"]) @ torch.diag_embed(scale)
    return L @ L.transpose(1, 2)


def sh_basis(d, degree: int):
    """[P, 16] the real SH basis (3DGS's signs) at unit directions d,
    zero past `degree`."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    basis = [torch.full_like(x, SH_C0),
             -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * z * z - x * x - y * y),
             SH_C2[3] * x * z, SH_C2[4] * (x * x - y * y),
             SH_C3[0] * y * (3 * x * x - y * y), SH_C3[1] * x * y * z,
             SH_C3[2] * y * (4 * z * z - x * x - y * y),
             SH_C3[3] * z * (2 * z * z - 3 * x * x - 3 * y * y),
             SH_C3[4] * x * (4 * z * z - x * x - y * y), SH_C3[5] * z * (x * x - y * y),
             SH_C3[6] * x * (x * x - 3 * y * y)]
    n = (degree + 1) ** 2
    return torch.stack([b if j < n else torch.zeros_like(b) for j, b in enumerate(basis)], -1)


def spherindrical_rgb(feats, means, campos, dt_detached, span: float, degree: int,
                      degree_t: int):
    """[P, 3] colours of features [P, 16 B, 3] (B time bands) at the sliced
    means, the harmonics' time argument mu_t - t given detached."""
    d = means - campos
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    basis = sh_basis(d, degree)
    out = torch.zeros_like(means)
    for k in range(min(degree_t, feats.shape[1] // 16 - 1) + 1):
        w = torch.cos(2 * math.pi * k * dt_detached / span)  # [P]
        out = out + w[:, None] * (basis[:, :, None] * feats[:, 16 * k:16 * k + 16]).sum(1)
    return torch.clamp_min(out + 0.5, 0.0)


class Sliced(NamedTuple):
    means: torch.Tensor  # [P, 3]
    cov3: torch.Tensor  # [P, 3, 3]
    opacity: torch.Tensor  # [P] sigmoid(o) x marginal
    rgb: torch.Tensor  # [P, 3]
    live: torch.Tensor  # [P] bool: active and marginal > 0.05
    marginal: torch.Tensor  # [P]


def slice_at(p: dict, mask, t: float, campos, span: float, degree: int, degree_t: int,
             marginal: bool = True, mean_offset: bool = True) -> Sliced:
    """The 4D Gaussians `p` sliced at time t (seconds). marginal False
    leaves the opacity unscaled by the marginal, mean_offset False the mean
    at mu_xyz (the control's faults)."""
    sigma = covariance_4d(p)
    s_xyz, s_xt, s_tt = sigma[:, :3, :3], sigma[:, :3, 3:], sigma[:, 3:, 3:]
    cov3 = s_xyz - s_xt @ s_xt.transpose(1, 2) / s_tt
    dt = t - p["t"][:, 0]
    means = p["xyz"] + s_xt[..., 0] / s_tt[..., 0] * dt[:, None] if mean_offset else p["xyz"]
    marg = torch.exp(-0.5 * dt * dt / s_tt[:, 0, 0])
    opacity = torch.sigmoid(p["opacity"][:, 0]) * (marg if marginal else 1.0)
    feats = torch.cat([p["f_dc"], p["f_rest"]], 1)
    rgb = spherindrical_rgb(feats, means, campos.to(means.dtype), (p["t"][:, 0] - t).detach(),
                            span, degree, degree_t)
    return Sliced(means, cov3, opacity, rgb, mask & (marg > MARGINAL_MIN), marg)


# ---------------------------------------------------------------------------
# Projection (3DGS's rasterizer) and the frame
# ---------------------------------------------------------------------------

def project(sl: Sliced, cam: dict, cfg: dict) -> R.Screen:
    """Screen-space splats of one camera (host matrices in `cam`): EWA
    with cfg["dilation"] added to the 2D covariance's diagonal."""
    means = sl.means
    dt, dev = means.dtype, means.device
    W, H = cam["width"], cam["height"]
    tile_x, tile_y = cfg["tile"]
    view = torch.as_tensor(cam["view"], device=dev).to(dt)
    proj = torch.as_tensor(cam["proj"], device=dev).to(dt)
    tan_x, tan_y = math.tan(cam["fovx"] / 2), math.tan(cam["fovy"] / 2)
    fx, fy = W / (2 * tan_x), H / (2 * tan_y)
    hom = torch.cat([means, torch.ones_like(means[:, :1])], 1)
    pv = hom @ view[:3].T
    ph = hom @ proj.T
    pw = 1.0 / (ph[:, 3] + 1e-7)
    nx, ny = ph[:, 0] * pw, ph[:, 1] * pw
    depth = pv[:, 2]
    in_frustum = ((depth > cfg["near"]) & (depth <= cfg["far"]) & (nx.abs() <= 1.3)
                  & (ny.abs() <= 1.3))
    tz = depth
    tx = torch.clamp(pv[:, 0] / tz, -1.3 * tan_x, 1.3 * tan_x) * tz
    ty = torch.clamp(pv[:, 1] / tz, -1.3 * tan_y, 1.3 * tan_y) * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                     zero, fy / tz, -fy * ty / (tz * tz)], -1).view(-1, 2, 3)
    T = J @ view[:3, :3]
    cov2 = T @ sl.cov3 @ T.transpose(1, 2)
    a = cov2[:, 0, 0] + cfg["dilation"]
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + cfg["dilation"]
    det = a * c - b * b
    det_ok = det > 0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    xs = ((nx + 1.0) * W - 1.0) * 0.5
    ys = ((ny + 1.0) * H - 1.0) * 0.5
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        r3 = 3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0))
        support = torch.sqrt(2.0 * torch.clamp_min(
            torch.log(255.0 * torch.clamp_min(sl.opacity, 1e-12)), 1e-2))
        rx = torch.ceil(torch.minimum(support * torch.sqrt(torch.clamp_min(a, 0.0)), r3))
        ry = torch.ceil(torch.minimum(support * torch.sqrt(torch.clamp_min(c, 0.0)), r3))
        gx, gy = -(-W // tile_x), -(-H // tile_y)

        def f(v):
            return torch.nan_to_num(v.float(), nan=0.0, posinf=3e9, neginf=-3e9)

        x0 = torch.trunc(f((xs - rx) / tile_x)).clamp(0, gx)
        y0 = torch.trunc(f((ys - ry) / tile_y)).clamp(0, gy)
        x1 = (torch.floor(f((xs + rx) / tile_x)) + 1).clamp(0, gx)
        y1 = (torch.floor(f((ys + ry) / tile_y)) + 1).clamp(0, gy)
        rect = torch.stack([x0, y0, x1, y1], -1).long()
        touched = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
        valid = in_frustum & det_ok & (touched > 0) & sl.live
        radius = torch.where(valid, torch.ceil(r3), torch.zeros_like(r3))
    return R.Screen(xy=torch.stack([xs, ys], -1), conic=conic, opacity=sl.opacity, rgb=sl.rgb,
                    depth=depth, rect=rect, valid=valid, radius=radius)


def screen(p: dict, mask, model: dict, cfg: dict, cam: dict, t: float, **fault) -> R.Screen:
    """The splats of `p` at time t as camera `cam` sees them. model holds
    the active degrees (`sh_degree`, `sh_degree_t`) and the time span
    (`span`); fault takes slice_at's marginal and mean_offset, and
    `sh_degree_t` in place of the model's."""
    campos = torch.as_tensor(cam["campos"], device=p["xyz"].device)
    degree_t = fault.pop("sh_degree_t", model["sh_degree_t"])
    sl = slice_at(p, mask, t, campos, model["span"], model["sh_degree"], degree_t, **fault)
    return project(sl, cam, cfg)


def render(p: dict, mask, model: dict, cfg: dict, cam: dict, t: float, bg):
    """(frame [H, W, 3], (contributing, applied) pairs) with no gradient."""
    with torch.no_grad():
        img, pairs, _ = R.composite(screen(p, mask, model, cfg, cam, t), cfg, cam, bg)
        return img, pairs


# ---------------------------------------------------------------------------
# The training step: V views, Adam
# ---------------------------------------------------------------------------

def learning_rates(cfg: dict, spatial_scale: float, iteration: int) -> dict:
    xyz = R._expon_lr(iteration, cfg["position_lr_init"] * spatial_scale,
                      cfg["position_lr_final"] * spatial_scale, cfg["position_lr_delay_mult"],
                      cfg["position_lr_max_steps"])
    return {"xyz": xyz, "t": xyz, "scaling": cfg["scaling_lr"], "scaling_t": cfg["scaling_lr"],
            "rotation": cfg["rotation_lr"], "rotation_r": cfg["rotation_lr"],
            "opacity": cfg["opacity_lr"], "f_dc": cfg["feature_lr"],
            "f_rest": cfg["feature_lr"] / 20.0}


def adam(p: dict, g: dict, state: dict, lrs: dict, eps: float):
    """One Adam step (torch.optim.Adam's): new params and state."""
    t = state["step"] + 1
    bias1, bias2 = 1 - BETA1 ** t, 1 - BETA2 ** t
    new_p, mu, nu = {}, {}, {}
    for k in p:
        mu[k] = BETA1 * state["mu"][k] + (1 - BETA1) * g[k]
        nu[k] = BETA2 * state["nu"][k] + (1 - BETA2) * g[k] * g[k]
        new_p[k] = p[k] - lrs[k] / bias1 * mu[k] / (torch.sqrt(nu[k]) / math.sqrt(bias2) + eps)
    return new_p, {"mu": mu, "nu": nu, "step": t}


def init_state(p: dict) -> dict:
    return {"mu": {k: torch.zeros_like(v) for k, v in p.items()},
            "nu": {k: torch.zeros_like(v) for k, v in p.items()}, "step": 0}


def init_stats(mask, dtype, device) -> dict:
    return {k: torch.zeros(mask.shape[0], dtype=dtype, device=device) for k in STATS}


class View(NamedTuple):
    cam: dict
    t: float  # seconds
    gt: torch.Tensor  # [H, W, 3]


class StepOutput(NamedTuple):
    params: dict
    state: dict
    stats: dict
    loss: float
    grads: dict  # as Adam takes them


def train_step(p: dict, state: dict, stats: dict, mask, model: dict, cfg: dict, views: list,
               bg, iteration: int, spatial_scale: float, views_in_loss: int | None = None,
               optimizer=adam, **fault) -> StepOutput:
    """One step over `views`: each rendered at its own time, the mean of
    the first `views_in_loss` (all by default) views' losses, Adam on the
    active rows (NaN gradients zeroed), the statistics of the batch. The
    gradient is carried view by view (image, screen-space splats,
    parameters), the sum of one graph's, in memory that fits."""
    n = len(views) if views_in_loss is None else views_in_loss
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    xy_grad = torch.zeros((mask.shape[0], 2), dtype=p["xyz"].dtype, device=p["xyz"].device)
    radius = torch.zeros(mask.shape[0], dtype=p["xyz"].dtype, device=p["xyz"].device)
    total = 0.0
    for v in views[:n]:
        scr = screen(leaves, mask, model, cfg, v.cam, v.t, **dict(fault))
        screen_leaves = [x.detach().requires_grad_(True)
                         for x in (scr.xy, scr.conic, scr.opacity, scr.rgb)]
        scr_l = scr._replace(xy=screen_leaves[0], conic=screen_leaves[1],
                             opacity=screen_leaves[2], rgb=screen_leaves[3])
        with torch.no_grad():
            img, _, _ = R.composite(scr_l, cfg, v.cam, bg)
        img = img.detach().requires_grad_(True)
        loss = R.image_loss(img, v.gt, cfg["lambda_dssim"]) / n
        (g_img,) = torch.autograd.grad(loss, img)
        R.composite(scr_l, cfg, v.cam, bg, grad_image=g_img)
        cots = [x.grad if x.grad is not None else torch.zeros_like(x) for x in screen_leaves]
        outs = [scr.xy, scr.conic, scr.opacity, scr.rgb]
        gs = torch.autograd.grad(outs, list(leaves.values()), grad_outputs=cots,
                                 allow_unused=True)
        for k, gk in zip(leaves, gs):
            if gk is not None:
                grads[k] = grads[k] + gk
        xy_grad = xy_grad + cots[0] * torch.tensor(
            [v.cam["width"] / 2.0, v.cam["height"] / 2.0], dtype=xy_grad.dtype,
            device=xy_grad.device)
        radius = torch.maximum(radius, scr.radius.to(radius.dtype))
        total += float(loss.detach())
    g = {}
    for k, gk in grads.items():
        gk = torch.where(mask.view(-1, *([1] * (gk.ndim - 1))), gk, torch.zeros_like(gk))
        g[k] = torch.where(torch.isnan(gk), torch.zeros_like(gk), gk)
    new_p, new_state = optimizer(p, g, state, learning_rates(cfg, spatial_scale, iteration),
                                 cfg["adam_eps"])
    on = (radius > 0) & mask & (iteration < cfg["densify_until_iter"])
    new_stats = {
        "max_radii2D": torch.where(on, torch.maximum(stats["max_radii2D"], radius),
                                   stats["max_radii2D"]),
        "xyz_gradient_accum": stats["xyz_gradient_accum"] + torch.where(
            on, torch.linalg.norm(xy_grad, dim=-1), 0.0),
        "denom": stats["denom"] + on.to(radius.dtype)}
    return StepOutput({k: v.detach() for k, v in new_p.items()}, new_state, new_stats, total, g)
