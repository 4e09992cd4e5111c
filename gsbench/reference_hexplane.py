"""The plain reference of 4D-GS (Wu et al., CVPR 2024;
github.com/hustvl/4DGaussians, its dynerf arguments): a frame and a
fine-stage training step of several views, in plain PyTorch, written from
the paper's and the source's equations and imported by nothing of the
program.

It computes in any floating dtype (float64 for the reference, bfloat16 for
the control), with TF32 off, from the parameters under the source's names
(the rows ROWS, the planes `grid.<scale>.<plane>`, the MLP's layers by
their module names), the field's box, the host camera matrices, the times
(normalised, in [0, 1)), the backgrounds and the images. Everything the
program derives is worked out here again:

  * the field's input is (2 (x - aabb_min) / (aabb_max - aabb_min) - 1, t);
    each of the 6 planes of a scale, (x,y), (x,z), (x,t), (y,z), (y,t),
    (z,t), each [C, R_b, R_a], is sampled by explicit bilinear lookups as
    F.grid_sample samples with align_corners=True and border padding (and
    its gradient: none to a coordinate clamped at or past the border); a
    scale's feature is the product of its samples, the scales concatenated;
  * the MLP: h = W_0 f + b_0, and each head W_2 relu(W_1 relu(h) + b_1) +
    b_2, for the position (3), scales (3), rotation (4), opacity (1) and SH
    (48) offsets, each added to its parameter before its activation (exp,
    q / |q|, sigmoid); the colour is max(SH_3(SH', d) + 0.5, 0) with d the
    unit vector from the camera centre to the deformed mean;
  * the projection is 3DGS's (`reference_fourdgs.project`: EWA with a 2D
    dilation, no opacity compensation), and screen-space splats are binned
    and composited as `gsbench/reference.py` composites, with the exact
    depth order;
  * a step renders each view at its own time, takes the mean of the views'
    L1 losses plus the planes' regularizers (plane_tv_weight times the
    spatial planes' mean squared second difference along their rows,
    time_smoothness_weight times the time planes', l1_time_planes times
    the time planes' mean |1 - P|), one gradient, then Adam (betas 0.9,
    0.999, the recipe's eps) at the scheduled rates, the rows' gradients
    masked to the active rows, and the batch's densification statistics.

Departures from the source, each named:
  * the tile rectangle is the least of the 3-sigma square and the box of
    the ellipse where alpha falls to 1/255 (the program's); it drops only
    pairs with alpha under 1/255, which the compositing skips;
  * the statistics take the screen-space mean gradient summed over the
    views and count a batch once where some view saw the Gaussian;
  * no densification events (clone, split, prune, opacity reset) and no
    coarse stage: the fine stage's step alone;
  * dead Gaussians are rows outside the mask, not removed.

The control's faults (`families/hexplane.py::faults`) are keywords here:
scale2_off (the second scale's features zeroed), dsh_off (no SH offset),
mlp_tf32 (the MLP's products with both operands rounded to TF32's 10
mantissa bits, as the tensor cores take them with TF32 on), reg_off (no
regularizer), time_planes_frozen (the time planes not updated).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gsbench import reference as R
from gsbench import reference_fourdgs as FR

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROWS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
TIME = (2, 4, 5)  # the planes of a scale that hold t
HEADS = (("pos_deform", 3), ("scales_deform", 3), ("rotations_deform", 4),
         ("opacity_deform", 1), ("shs_deform", 48))
STATS = FR.STATS
BETA1, BETA2 = FR.BETA1, FR.BETA2


def field_shapes(cfg: dict) -> dict:
    """name -> shape of the field's parameters from the configuration's
    widths: the planes `grid.<scale>.<pair>` [C, R_b, R_a], scale-major,
    and the MLP's layers under the source's module names."""
    out = {}
    planes = cfg["kplanes_config"]
    C = planes["output_coordinate_dim"]
    for s, m in enumerate(cfg["multires"]):
        res = [r * m for r in planes["resolution"][:3]] + list(planes["resolution"][3:])
        for k, (a, b) in enumerate(PAIRS):
            out[f"grid.{s}.{k}"] = (C, res[b], res[a])
    W = cfg["net_width"]
    for i in range(cfg["defor_depth"] + 1):
        out[f"feature_out.{2 * i}.weight"] = (W, C * len(cfg["multires"]) if i == 0 else W)
        out[f"feature_out.{2 * i}.bias"] = (W,)
    for head, k in HEADS:
        out.update({f"{head}.1.weight": (W, W), f"{head}.1.bias": (W,),
                    f"{head}.3.weight": (k, W), f"{head}.3.bias": (k,)})
    return out


# ---------------------------------------------------------------------------
# The field
# ---------------------------------------------------------------------------

def _coordinate(c, R: int):
    """(i0, w) of one axis of R cells: u = (c + 1) / 2 (R - 1), clamped to
    [0, R - 1] with no gradient where it was clamped (at the border
    too, as grid_sample), i0 = min(floor(u), R - 2), w = u - i0."""
    u = (c + 1) / 2 * (R - 1)
    inside = (u > 0) & (u < R - 1)
    u = torch.where(inside, u, u.detach().clamp(0, R - 1))
    i0 = torch.clamp(torch.floor(u.detach()), 0, R - 2)
    return i0.long(), u - i0


def sample_plane(plane, ca, cb):
    """[N, C] bilinear samples of plane [C, R_b, R_a] at (ca, cb) in [-1, 1]
    (align_corners, border): four explicit lookups."""
    C, Rb, Ra = plane.shape
    ia, wa = _coordinate(ca, Ra)
    ib, wb = _coordinate(cb, Rb)
    flat = plane.reshape(C, Rb * Ra)

    def at(j, i):
        return flat[:, j * Ra + i].T

    wa, wb = wa[:, None], wb[:, None]
    return ((1 - wa) * (1 - wb) * at(ib, ia) + wa * (1 - wb) * at(ib, ia + 1)
            + (1 - wa) * wb * at(ib + 1, ia) + wa * wb * at(ib + 1, ia + 1))


def n_scales(p: dict) -> int:
    return sum(1 for k in p if k.startswith("grid.")) // len(PAIRS)


def field(p: dict, coords, scale2_off: bool = False):
    """f [N, C x scales] at coords [N, 4]; scale2_off zeroes every scale's
    features past the first."""
    out = []
    for s in range(n_scales(p)):
        f = 1.0
        for k, (a, b) in enumerate(PAIRS):
            f = f * sample_plane(p[f"grid.{s}.{k}"], coords[:, a], coords[:, b])
        out.append(f * 0 if scale2_off and s > 0 else f)
    return torch.cat(out, -1)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest) in x's dtype."""
    bits = x.detach().float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)
    return x + (rounded - x).detach()


class _TF32Linear(torch.autograd.Function):
    """A linear layer whose three products take both operands rounded to
    TF32, as a float32 GEMM with TF32 on does, forward and backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _tf32(x) @ _tf32(w).T + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _tf32(g) @ _tf32(w), _tf32(g).T @ _tf32(x), g.sum(0)


def mlp(p: dict, f, mlp_tf32: bool = False, dsh_off: bool = False) -> list:
    """The five heads' offsets [N, k] of the features f."""
    def linear(x, name):
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        return _TF32Linear.apply(x, w, b) if mlp_tf32 else x @ w.T + b

    h = f
    depth = sum(1 for k in p if k.startswith("feature_out.") and k.endswith(".weight"))
    for i in range(depth):
        h = linear(torch.relu(h) if i else h, f"feature_out.{2 * i}")
    hr = torch.relu(h)
    out = [linear(torch.relu(linear(hr, f"{head}.1")), f"{head}.3") for head, _ in HEADS]
    if dsh_off:
        out[-1] = out[-1] * 0
    return out


def deformed(p: dict, aabb, t: float, scale2_off: bool = False, mlp_tf32: bool = False,
             dsh_off: bool = False):
    """(x', s', q', o' [N], SH' [N, 16, 3]) of the rows at time t, before
    the activations."""
    xyz = p["xyz"]
    lo, hi = aabb[0].to(xyz.dtype), aabb[1].to(xyz.dtype)
    c = (xyz - lo) * (2.0 / (hi - lo)) - 1.0
    coords = torch.cat([c, torch.full_like(c[:, :1], t)], -1)
    dx, ds, dr, do, dsh = mlp(p, field(p, coords, scale2_off), mlp_tf32, dsh_off)
    sh = torch.cat([p["f_dc"], p["f_rest"]], 1)
    return (xyz + dx, p["scaling"] + ds, p["rotation"] + dr, (p["opacity"] + do)[:, 0],
            sh + dsh.view(sh.shape))


def covariance(scaling, rotation):
    """[N, 3, 3] R S S^T R^T of log-scales and an unnormalised quaternion."""
    r, x, y, z = (rotation / torch.linalg.norm(rotation, dim=-1, keepdim=True)).unbind(-1)
    Rm = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
                      2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
                      2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
                     -1).view(-1, 3, 3)
    M = Rm * torch.exp(scaling)[:, None, :]
    return M @ M.transpose(1, 2)


# ---------------------------------------------------------------------------
# The frame
# ---------------------------------------------------------------------------

def screen(p: dict, mask, aabb, cfg: dict, cam: dict, t: float, **fault) -> R.Screen:
    """The splats of `p` deformed to time t as camera `cam` sees them;
    fault takes deformed's keywords."""
    means, s, q, o, sh = deformed(p, aabb, t, **fault)
    campos = torch.as_tensor(cam["campos"], device=means.device).to(means.dtype)
    d = means - campos
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rgb = torch.clamp_min((FR.sh_basis(d, cfg["sh_degree"])[:, :, None] * sh).sum(1) + 0.5, 0.0)
    sl = FR.Sliced(means=means, cov3=covariance(s, q), opacity=torch.sigmoid(o), rgb=rgb,
                   live=mask, marginal=torch.ones_like(o))
    return FR.project(sl, cam, cfg)


def render(p: dict, mask, aabb, cfg: dict, cam: dict, t: float, bg):
    """(frame [H, W, 3], (contributing, applied) pairs) with no gradient."""
    with torch.no_grad():
        img, pairs, _ = R.composite(screen(p, mask, aabb, cfg, cam, t), cfg, cam, bg)
        return img, pairs


# ---------------------------------------------------------------------------
# The training step: V views, Adam
# ---------------------------------------------------------------------------

def plane_smoothness(plane):
    """Mean squared second difference of [C, R_b, R_a] along R_b."""
    d1 = plane[:, 1:] - plane[:, :-1]
    return ((d1[:, 1:] - d1[:, :-1]) ** 2).mean()


def regularizers(p: dict, cfg: dict):
    spatial = smooth = ones = 0.0
    for s in range(n_scales(p)):
        for k in range(len(PAIRS)):
            plane = p[f"grid.{s}.{k}"]
            if k in TIME:
                smooth = smooth + plane_smoothness(plane)
                ones = ones + (1 - plane).abs().mean()
            else:
                spatial = spatial + plane_smoothness(plane)
    return (cfg["plane_tv_weight"] * spatial + cfg["time_smoothness_weight"] * smooth
            + cfg["l1_time_planes"] * ones)


def learning_rates(cfg: dict, spatial_scale: float, iteration: int, names) -> dict:
    def sched(init, final):
        return R._expon_lr(iteration, init * spatial_scale, final * spatial_scale,
                           cfg["position_lr_delay_mult"], cfg["position_lr_max_steps"])

    fixed = {"xyz": sched(cfg["position_lr_init"], cfg["position_lr_final"]),
             "f_dc": cfg["feature_lr"], "f_rest": cfg["feature_lr"] / 20.0,
             "opacity": cfg["opacity_lr"], "scaling": cfg["scaling_lr"],
             "rotation": cfg["rotation_lr"]}
    grid = sched(cfg["grid_lr_init"], cfg["grid_lr_final"])
    deformation = sched(cfg["deformation_lr_init"], cfg["deformation_lr_final"])
    return {k: fixed[k] if k in fixed else grid if k.startswith("grid.") else deformation
            for k in names}


class View(NamedTuple):
    cam: dict
    t: float  # normalised time
    gt: torch.Tensor  # [H, W, 3]


class StepOutput(NamedTuple):
    params: dict
    state: dict
    stats: dict
    loss: float
    grads: dict  # as Adam takes them


def train_step(p: dict, state: dict, stats: dict, mask, aabb, cfg: dict, views: list, bg,
               iteration: int, spatial_scale: float, reg_off: bool = False,
               time_planes_frozen: bool = False, **fault) -> StepOutput:
    """One step over `views`: each deformed to and rendered at its own
    time, the mean of the views' L1 plus the regularizers, Adam (the rows'
    gradients masked to the active rows, NaN zeroed), the statistics of
    the batch. The gradient is carried view by view (image, screen-space
    splats, parameters), the sum of one graph's, in memory that fits."""
    n = len(views)
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    dt, dev = p["xyz"].dtype, p["xyz"].device
    xy_grad = torch.zeros((mask.shape[0], 2), dtype=dt, device=dev)
    radius = torch.zeros(mask.shape[0], dtype=dt, device=dev)
    total = 0.0

    def add(gs):
        for k, gk in zip(leaves, gs):
            if gk is not None:
                grads[k] = grads[k] + gk

    for v in views:
        scr = screen(leaves, mask, aabb, cfg, v.cam, v.t, **fault)
        screen_leaves = [x.detach().requires_grad_(True)
                         for x in (scr.xy, scr.conic, scr.opacity, scr.rgb)]
        scr_l = scr._replace(xy=screen_leaves[0], conic=screen_leaves[1],
                             opacity=screen_leaves[2], rgb=screen_leaves[3])
        with torch.no_grad():
            img, _, _ = R.composite(scr_l, cfg, v.cam, bg)
        img = img.detach().requires_grad_(True)
        loss = (img - v.gt).abs().mean() / n
        (g_img,) = torch.autograd.grad(loss, img)
        R.composite(scr_l, cfg, v.cam, bg, grad_image=g_img)
        cots = [x.grad if x.grad is not None else torch.zeros_like(x) for x in screen_leaves]
        add(torch.autograd.grad([scr.xy, scr.conic, scr.opacity, scr.rgb], list(leaves.values()),
                                grad_outputs=cots, allow_unused=True))
        xy_grad = xy_grad + cots[0] * torch.tensor(
            [v.cam["width"] / 2.0, v.cam["height"] / 2.0], dtype=dt, device=dev)
        radius = torch.maximum(radius, scr.radius.to(dt))
        total += float(loss.detach())
        del scr, scr_l, screen_leaves, cots
    if not reg_off:
        reg = regularizers(leaves, cfg)
        add(torch.autograd.grad(reg, list(leaves.values()), allow_unused=True))
        total += float(reg.detach())
    g = {}
    for k, gk in grads.items():
        if k in ROWS:
            gk = torch.where(mask.view(-1, *([1] * (gk.ndim - 1))), gk, torch.zeros_like(gk))
        if time_planes_frozen and k.startswith("grid.") and int(k.split(".")[2]) in TIME:
            gk = torch.zeros_like(gk)
        g[k] = torch.where(torch.isnan(gk), torch.zeros_like(gk), gk)
    new_p, new_state = FR.adam(p, g, state, learning_rates(cfg, spatial_scale, iteration, p),
                               cfg["adam_eps"])
    on = (radius > 0) & mask & (iteration < cfg["densify_until_iter"])
    new_stats = {
        "max_radii2D": torch.where(on, torch.maximum(stats["max_radii2D"], radius),
                                   stats["max_radii2D"]),
        "xyz_gradient_accum": stats["xyz_gradient_accum"] + torch.where(
            on, torch.linalg.norm(xy_grad, dim=-1), 0.0),
        "denom": stats["denom"] + on.to(dt)}
    return StepOutput({k: v.detach() for k, v in new_p.items()}, new_state, new_stats, total, g)


def init_state(p: dict) -> dict:
    return FR.init_state(p)


def init_stats(mask, dtype, device) -> dict:
    return FR.init_stats(mask, dtype, device)

