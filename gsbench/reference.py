"""The plain reference: 4D Gaussian splatting's frame and training step in
plain PyTorch, written from the algorithm (Ex4DGS: keyframed dynamic
splats, EWA splatting, tile-binned front-to-back alpha compositing, L1 +
SSIM, RAdam) and imported by nothing of the program.

It computes in any floating dtype (float64 for the reference, bfloat16 for
the control) from the benchmark's own inputs: the scene's parameters, the
host camera matrices, the timestamps, the backgrounds and the images.
Everything the program derives (projected splats, tile lists, depth order,
per-step matrices) is worked out here again.

Semantics held to, each a rule of the algorithm as the configuration runs it:
  * a splat touches the tiles of its screen rectangle: the per-axis least of
    its 3-sigma square and the bounding box of the ellipse where its alpha
    falls to 1/255; a tile's splats are composited in depth order, with the
    depth's float32 bits cut to the bits left beside the tile id (splats
    within ~2^-11 relative depth blend in index order), or exactly with
    `exact_sort`;
  * a pair (splat, pixel) contributes when its power is <= 0 and its alpha,
    min(opacity * exp(power), 0.99), is >= 1/255; it is applied while the
    transmittance after it stays >= 1e-4; the pixel's colour is the applied
    weights' sum plus the final transmittance times the background;
  * gradients pass the 0.99 clamp unchanged (straight through);
  * the loss is (1 - l) L1 + l (1 - SSIM) (11-tap Gaussian window, sigma
    1.5, zero padding) plus the displacement and motion regularizers, and
    RAdam updates every active row, its learning rates from the schedule;
  * while densification runs, each visible splat's statistics accumulate:
    its largest and smallest screen radius (ceil of 3 sigma), the norm of
    its screen-space mean's gradient in NDC units, a count, and its
    blending weight and the weight-shared L1 and SSIM of the pixels it
    covers, with the frame of its least error.

The frame is composited in blocks of tiles of similar list length. The
training step takes the image's gradient first, then runs each block again
with autograd to carry it to the projected splats, then carries those to
the parameters: the same gradient as one graph, in memory that fits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
BLOCK_ELEMENTS = 1 << 24  # (tile, instance, pixel) elements composited at once


def time_shift(cfg: dict) -> int:
    if cfg["interp_type"] in ("cube", "pchip"):
        return cfg["time_pad"] + cfg["time_interval"]
    return cfg["time_pad"]


# ---------------------------------------------------------------------------
# The splats at time t
# ---------------------------------------------------------------------------

def _keyframe(y, k: int):
    """y[:, k], NaN outside the keyframe axis (the splat then leaves the
    frustum)."""
    K = y.shape[1]
    if -K <= k < K:
        return y[:, k]
    return torch.full_like(y[:, 0], float("nan"))


def _slerp(q0, q1, t):
    q0 = q0 / torch.linalg.norm(q0, dim=-1, keepdim=True)
    q1 = q1 / torch.linalg.norm(q1, dim=-1, keepdim=True)
    d = torch.clamp((q0 * q1).sum(-1, keepdim=True), -1 + 1e-4, 1 - 1e-4)
    omega = torch.clamp_min(torch.arccos(d), 1e-4)
    s = torch.clamp_min(torch.sin(omega), 1e-4)
    p0 = torch.sin((1.0 - t) * omega) / s
    p1 = torch.sin(t * omega) / s
    tot = torch.clamp_min(p0 + p1, 1e-4)
    q = q0 * (p0 / tot) + q1 * (p1 / tot)
    q = torch.where(q.abs().sum(-1, keepdim=True) > 1e-4, q, q0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _interp(kind: str, y, k: int, dt):
    if kind in ("cube", "cubic"):
        ym, y0, y1, y2 = (_keyframe(y, k + o) for o in (-1, 0, 1, 2))
        m0, m1 = (y1 - ym) / 2.0, (y2 - y0) / 2.0
        t2 = dt * dt
        t3 = t2 * dt
        return ((2 * t3 - 3 * t2 + 1) * y0 + (t3 - 2 * t2 + dt) * m0
                + (-2 * t3 + 3 * t2) * y1 + (t3 - t2) * m1)
    if kind == "linear":
        y0, y1 = _keyframe(y, k), _keyframe(y, k + 1)
        return y0 * (1.0 - dt) + y1 * dt
    raise NotImplementedError(f"reference interpolation {kind!r}")


def splats_at(p: dict, masks: tuple, scene: dict, cfg: dict, t: float):
    """(means [P, 3], quaternions [P, 4], scales [P, 3], opacity [P],
    SH [P, 16, 3], active [P]) at timestamp t, static rows first."""
    dt_ = p["xyz"].dtype
    shift, interval = time_shift(cfg), cfg["time_interval"]
    means = [p["xyz"] + p["xyz_disp"] * (t / scene["duration"])]
    rots, scales = [p["rotation"]], [torch.exp(p["scaling"])]
    opac = [torch.sigmoid(p["opacity"])[:, 0]]
    feats = [torch.cat([p["f_dc"], p["f_rest"]], 1)]
    # the keyframe index is taken in float32, as a host timestamp is
    k = int(np.floor((np.float32(t) + np.float32(shift)) / np.float32(interval)))
    tt = torch.tensor(t + shift, dtype=dt_, device=p["xyz"].device)
    dt = torch.remainder(tt, interval) / interval
    tu = (t + shift) / interval
    c, v = p["motion_opacity_center"], p["motion_opacity_var"]
    m = torch.amin(tu - c, dim=1)
    var = torch.where((tu > c).any(1), v[:, 1], v[:, 0])
    env = torch.exp(-(m ** 2) / (torch.exp(var) + (cfg["var_pad"] / interval) / 2.36) ** 2)
    env = torch.where((c[:, 0] - tu) * (c[:, 1] - tu) < 0, torch.ones_like(env), env)
    means.append(_interp(cfg["interp_type"], p["motion_xyz"], k, dt))
    q0, q1 = _keyframe(p["motion_rotation"], k), _keyframe(p["motion_rotation"], k + 1)
    rots.append(_slerp(q0, q1, dt) if cfg["rot_interp_type"] == "slerp"
                else q0 * (1 - dt) + q1 * dt)
    scales.append(torch.exp(p["motion_scaling"]))
    opac.append(torch.sigmoid(p["motion_opacity"])[:, 0] * env)
    feats.append(torch.cat([p["motion_f_dc"], p["motion_f_rest"]], 1))
    feats = torch.cat(feats)
    band = torch.arange(feats.shape[1], device=feats.device) < (scene["active_sh_degree"] + 1) ** 2
    return (torch.cat(means), torch.cat(rots), torch.cat(scales), torch.cat(opac),
            feats * band[None, :, None], torch.cat(masks))


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

class Screen(NamedTuple):
    xy: torch.Tensor  # [P, 2] pixel coordinates
    conic: torch.Tensor  # [P, 3] inverse of the dilated 2-D covariance (a, b, c)
    opacity: torch.Tensor  # [P] opacity x low-pass compensation
    rgb: torch.Tensor  # [P, 3]
    depth: torch.Tensor  # [P] camera-space z
    rect: torch.Tensor  # [P, 4] int64 tile rectangle x0, y0, x1, y1 (exclusive)
    valid: torch.Tensor  # [P] bool
    radius: torch.Tensor  # [P] ceil of 3 sigma in pixels, 0 where not valid


def _sh_rgb(sh, means, campos):
    d = means - campos
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-12)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = [torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * xz,
             SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4 * zz - xx - yy),
             SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
             SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    b = torch.cat(basis, dim=1)[:, :sh.shape[1]]  # [P, K]
    return torch.clamp_min((b[:, :, None] * sh).sum(1) + 0.5, 0.0)


def project(means, quats, scales, opac, sh, active, cam: dict, cfg: dict) -> Screen:
    """Screen-space splats of one camera (host matrices in `cam`)."""
    dt, dev = means.dtype, means.device
    W, H = cam["width"], cam["height"]
    tile_x, tile_y = cfg["tile"]
    view = torch.as_tensor(cam["view"], device=dev).to(dt)
    proj = torch.as_tensor(cam["proj"], device=dev).to(dt)
    campos = torch.as_tensor(cam["campos"], device=dev).to(dt)
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

    r, x, y, z = quats.unbind(-1)
    R = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
                     2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
                     2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
                    -1).view(-1, 3, 3)
    M = R * scales[:, None, :]
    cov3 = M @ M.transpose(1, 2)

    tz = depth
    tx = torch.clamp(pv[:, 0] / tz, -1.3 * tan_x, 1.3 * tan_x) * tz
    ty = torch.clamp(pv[:, 1] / tz, -1.3 * tan_y, 1.3 * tan_y) * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                     zero, fy / tz, -fy * ty / (tz * tz)], -1).view(-1, 2, 3)
    T = J @ view[:3, :3]
    cov2 = T @ cov3 @ T.transpose(1, 2)
    a, b, c = cov2[:, 0, 0], cov2[:, 0, 1], cov2[:, 1, 1]
    ks = cfg["kernel_size"]
    det0 = torch.clamp_min(a * c - b * b, 1e-6)
    det1 = torch.clamp_min((a + ks) * (c + ks) - b * b, 1e-6)
    coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)
    coef = torch.where((det0 <= 1e-6) | (det1 <= 1e-6), torch.zeros_like(coef), coef)
    a, c = a + ks, c + ks
    det = a * c - b * b
    det_ok = det > 0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    opacity = opac * coef

    xs = ((nx + 1.0) * W - 1.0) * 0.5
    ys = ((ny + 1.0) * H - 1.0) * 0.5
    # the rectangle: 3 sigma, cut to where alpha falls below 1/255
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        r3 = 3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0))
        support = torch.sqrt(2.0 * torch.clamp_min(
            torch.log(255.0 * torch.clamp_min(opacity, 1e-12)), 1e-2))
        rx = torch.ceil(torch.minimum(support * torch.sqrt(torch.clamp_min(a, 0.0)), r3))
        ry = torch.ceil(torch.minimum(support * torch.sqrt(torch.clamp_min(c, 0.0)), r3))
        gx, gy = -(-W // tile_x), -(-H // tile_y)
        f = lambda v: torch.nan_to_num(v.float(), nan=0.0, posinf=3e9, neginf=-3e9)  # noqa: E731
        x0 = torch.trunc(f((xs - rx) / tile_x)).clamp(0, gx)
        y0 = torch.trunc(f((ys - ry) / tile_y)).clamp(0, gy)
        x1 = (torch.floor(f((xs + rx) / tile_x)) + 1).clamp(0, gx)
        y1 = (torch.floor(f((ys + ry) / tile_y)) + 1).clamp(0, gy)
        rect = torch.stack([x0, y0, x1, y1], -1).long()
        touched = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
        valid = in_frustum & det_ok & (touched > 0) & active
        radius = torch.where(valid, torch.ceil(r3), torch.zeros_like(r3))
    return Screen(xy=torch.stack([xs, ys], -1), conic=conic, opacity=opacity,
                  rgb=_sh_rgb(sh, means, campos), depth=depth, rect=rect, valid=valid,
                  radius=radius)


# ---------------------------------------------------------------------------
# Binning and compositing
# ---------------------------------------------------------------------------

def tile_lists(scr: Screen, cfg: dict, width: int, height: int):
    """(splat index per instance in composite order, start and count of each
    tile's run)."""
    dev = scr.xy.device
    tile_x, tile_y = cfg["tile"]
    gx, gy = -(-width // tile_x), -(-height // tile_y)
    ids = torch.nonzero(scr.valid)[:, 0]
    r = scr.rect[ids]
    w = r[:, 2] - r[:, 0]
    n = w * (r[:, 3] - r[:, 1])
    g = torch.repeat_interleave(torch.arange(ids.shape[0], device=dev), n)
    local = torch.arange(g.shape[0], device=dev) - (torch.cumsum(n, 0) - n)[g]
    tile = (r[g, 1] + local // w[g]) * gx + r[g, 0] + local % w[g]
    depth32 = scr.depth.detach()[ids][g].float()
    if cfg["exact_sort"]:
        by_depth = torch.sort(depth32, stable=True).indices
        order = by_depth[torch.sort(tile[by_depth], stable=True).indices]
    else:
        bits = 31 - (gx * gy).bit_length()
        key = (tile << bits) | (depth32.view(torch.int32).long() >> (31 - bits))
        order = torch.sort(key, stable=True).indices
    count = torch.bincount(tile, minlength=gx * gy)
    start = torch.cumsum(count, 0) - count
    return ids[g[order]], start, count


def _pixels(tiles, gx: int, tile_x: int, tile_y: int, dtype):
    py, px = torch.meshgrid(torch.arange(tile_y, device=tiles.device),
                            torch.arange(tile_x, device=tiles.device), indexing="ij")
    x = (tiles % gx)[:, None] * tile_x + px.reshape(1, -1)
    y = (tiles // gx)[:, None] * tile_y + py.reshape(1, -1)
    return x.to(dtype), y.to(dtype)


def _blend(xy, conic, opac, rgb, ok, px, py, bg):
    """Colour [B, Pix, 3], final transmittance, pair counts and blending
    weights [B, L, Pix] of a block: splats [B, L, ...] in composite order,
    pixels [B, Pix]."""
    dx = xy[:, :, 0, None] - px[:, None, :]
    dy = xy[:, :, 1, None] - py[:, None, :]
    a, b, c = (conic[:, :, i, None] for i in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    raw = opac[:, :, None] * torch.exp(torch.clamp_max(power, 0.0))
    alpha_c = raw + (torch.clamp_max(raw, ALPHA_MAX) - raw).detach()
    m = ok[:, :, None] & (power <= 0) & (alpha_c >= ALPHA_MIN)
    alpha = torch.where(m, alpha_c, torch.zeros_like(alpha_c))
    cum = torch.cumprod(1.0 - alpha, dim=1)
    excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], 1)
    applied = m & (cum >= T_EPS)
    w = torch.where(applied, alpha * excl, torch.zeros_like(alpha))
    t_final = torch.where(applied, 1.0 - alpha, torch.ones_like(alpha)).prod(1)
    color = torch.einsum("blp,blc->bpc", w, rgb) + t_final[..., None] * bg
    counts = (int((m & (excl >= T_EPS)).sum()), int(applied.sum()))
    return color, t_final, counts, w


def _blocks(start, count, budget_pixels: int):
    """Tiles with instances, by list length, in blocks of about
    BLOCK_ELEMENTS (tile, instance, pixel) elements."""
    tiles = torch.nonzero(count)[:, 0]
    lens = count[tiles]
    order = torch.argsort(lens, descending=True)
    tiles, lens = tiles[order].tolist(), lens[order].tolist()
    i = 0
    while i < len(tiles):
        L = lens[i]
        nb = max(1, BLOCK_ELEMENTS // (L * budget_pixels))
        yield torch.tensor(tiles[i:i + nb], device=start.device), L
        i += nb


def composite(scr: Screen, cfg: dict, cam: dict, bg, grad_image=None, pixel_weights=None):
    """The frame [H, W, 3], its pair counts (contributing, applied) and its
    accumulated alpha [H, W]. With grad_image (dL/dframe), the gradient is
    accumulated into the leaves of `scr`'s xy, conic, opacity and rgb
    instead, and with pixel_weights [H, W, C] too, each splat's sum over
    its pixels of its blending weight times theirs is returned [P, C]."""
    W, H = cam["width"], cam["height"]
    tile_x, tile_y = cfg["tile"]
    gx, gy = -(-W // tile_x), -(-H // tile_y)
    npix = tile_x * tile_y
    order, start, count = tile_lists(scr, cfg, W, H)
    dt, dev = scr.xy.dtype, scr.xy.device
    img = torch.empty((gy * tile_y, gx * tile_x, 3), dtype=dt, device=dev)
    img[:] = bg.detach()
    acc = torch.zeros((gy * tile_y, gx * tile_x), dtype=dt, device=dev)
    pairs = [0, 0]
    per_splat = None
    if grad_image is not None:
        gpad = torch.zeros((gy * tile_y, gx * tile_x, 3), dtype=dt, device=dev)
        gpad[:H, :W] = grad_image
        gtiles = gpad.view(gy, tile_y, gx, tile_x, 3).permute(0, 2, 1, 3, 4).reshape(
            gx * gy, npix, 3)
        if pixel_weights is not None:
            C = pixel_weights.shape[-1]
            wpad = torch.zeros((gy * tile_y, gx * tile_x, C), dtype=dt, device=dev)
            wpad[:H, :W] = pixel_weights
            wtiles = wpad.view(gy, tile_y, gx, tile_x, C).permute(0, 2, 1, 3, 4).reshape(
                gx * gy, npix, C)
            per_splat = torch.zeros((scr.xy.shape[0], C), dtype=dt, device=dev)
    for tiles, L in _blocks(start, count, npix):
        lane = torch.arange(L, device=dev)
        idx = start[tiles][:, None] + lane[None]
        ok = lane[None] < count[tiles][:, None]
        sid = order[idx.clamp_max(order.shape[0] - 1)]
        px, py = _pixels(tiles, gx, tile_x, tile_y, dt)
        with torch.set_grad_enabled(grad_image is not None):
            color, t_final, cnt, w = _blend(scr.xy[sid], scr.conic[sid], scr.opacity[sid],
                                            scr.rgb[sid], ok, px, py, bg)
        if grad_image is not None:
            color.backward(gtiles[tiles])
            if per_splat is not None:
                share = torch.einsum("blp,bpc->blc", w.detach(), wtiles[tiles])
                per_splat.index_add_(0, sid[ok], share[ok])
            continue
        pairs[0] += cnt[0]
        pairs[1] += cnt[1]
        ty, tx = tiles // gx, tiles % gx
        blk = img.view(gy, tile_y, gx, tile_x, 3)
        blk[ty, :, tx] = color.detach().view(-1, tile_y, tile_x, 3)
        acc.view(gy, tile_y, gx, tile_x)[ty, :, tx] = (1.0 - t_final.detach()).view(
            -1, tile_y, tile_x)
    if grad_image is not None:
        return per_splat
    return img[:H, :W], tuple(pairs), acc[:H, :W]


def render(params: dict, masks: tuple, scene: dict, cfg: dict, cam: dict, t: float, bg):
    """(frame [H, W, 3], (contributing, applied) pairs) with no gradient."""
    with torch.no_grad():
        scr = project(*splats_at(params, masks, scene, cfg, t), cam, cfg)
        img, pairs, _ = composite(scr, cfg, cam, bg)
        return img, pairs


# ---------------------------------------------------------------------------
# Loss and optimizer
# ---------------------------------------------------------------------------

def _blur(x):
    """Separable 11-tap Gaussian (sigma 1.5) blur of [C, H, W], zero padded."""
    g = torch.tensor([math.exp(-((i - 5) ** 2) / (2 * 1.5 ** 2)) for i in range(11)],
                     dtype=torch.float64)
    g = (g / g.sum()).to(device=x.device, dtype=x.dtype)
    C = x.shape[0]
    x = F.conv2d(x[None], g.view(1, 1, 11, 1).expand(C, 1, 11, 1), padding=(5, 0), groups=C)
    x = F.conv2d(x, g.view(1, 1, 1, 11).expand(C, 1, 1, 11), padding=(0, 5), groups=C)
    return x[0]


def ssim_map(x, y):
    """The SSIM map [C, H, W] of two [C, H, W] images."""
    mu1, mu2 = _blur(x), _blur(y)
    s11, s22, s12 = _blur(x * x) - mu1 * mu1, _blur(y * y) - mu2 * mu2, _blur(x * y) - mu1 * mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / ((mu1 * mu1 + mu2 * mu2 + C1)
                                                      * (s11 + s22 + C2))


def image_loss(img, gt, lambda_dssim: float, rows=None):
    """(1 - l) L1 + l (1 - SSIM) of [H, W, 3] images; `rows` limits both
    means to a row range (the tests' half-batch fault)."""
    x, y = img.permute(2, 0, 1), gt.permute(2, 0, 1)
    ssim = ssim_map(x, y)
    l1 = (x - y).abs()
    if rows is not None:
        ssim, l1 = ssim[:, rows], l1[:, rows]
    return (1.0 - lambda_dssim) * l1.mean() + lambda_dssim * (1.0 - ssim.mean())


def _safe_norm(v):
    sq = (v * v).sum(-1)
    ok = sq > 0
    return torch.where(ok, torch.sqrt(torch.where(ok, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def regularizers(p: dict, masks: tuple, opt: dict, iteration: int, keyframe_num: int):
    """The displacement and motion (and rotation) regularizers, each on
    from its iteration as the schedule gates it."""
    smask, dmask = (m.to(p["xyz"].dtype) for m in masks)
    loss = torch.zeros((), dtype=p["xyz"].dtype, device=p["xyz"].device)
    if opt["static_reg"] > 0 and iteration > opt["progressive_growing_steps"] + opt[
            "make_dynamic_interval"]:
        disp = torch.log(_safe_norm(p["xyz_disp"]) + 0.001) * smask
        loss = loss + opt["static_reg"] * disp.sum() / smask.sum().clamp_min(1)
    if (dmask.sum() > 0 and iteration > opt["progressive_growing_steps"] * opt["extract_every"]
            + opt["make_dynamic_interval"]):
        K = p["motion_xyz"].shape[1]
        kf = (torch.arange(1, K, device=dmask.device) < keyframe_num).to(dmask.dtype)
        m = dmask[:, None] * kf[None]
        denom = m.sum().clamp_min(1)
        if opt["motion_reg"] > 0:
            d = _safe_norm(p["motion_xyz"][:, :1] - p["motion_xyz"][:, 1:])
            loss = loss + opt["motion_reg"] * (d * m).sum() / denom
        if opt["rot_reg"] > 0:
            r1, r2 = p["motion_rotation"][:, 1:], p["motion_rotation"][:, :-1]
            n1 = torch.linalg.norm(r1, dim=-1).clamp_min(1e-6)
            n2 = torch.linalg.norm(r2, dim=-1).clamp_min(1e-6)
            loss = loss + opt["rot_reg"] * ((1 - (r1 * r2).sum(-1) / n1 / n2) * m).sum() / denom
    return loss


def _expon_lr(step, init, final, delay_mult, max_steps):
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


def learning_rates(opt: dict, spatial_scale: float, iteration: int) -> dict:
    xyz = _expon_lr(iteration, opt["position_lr_init"] * spatial_scale,
                    opt["position_lr_final"] * spatial_scale, opt["position_lr_delay_mult"],
                    opt["position_lr_max_steps"])
    mxyz = _expon_lr(iteration, opt["dynamic_position_lr_init"] * spatial_scale,
                     opt["dynamic_position_lr_final"] * spatial_scale,
                     opt["dynamic_position_lr_delay_mult"], opt["dynamic_position_lr_max_steps"])
    return {"xyz": xyz, "f_dc": opt["feature_lr"], "f_rest": opt["feature_lr"] / 20.0,
            "opacity": opt["opacity_lr"], "scaling": opt["scaling_lr"],
            "rotation": opt["rotation_lr"], "xyz_disp": opt["disp_lr"], "motion_xyz": mxyz,
            "motion_f_dc": opt["feature_motion_lr"],
            "motion_f_rest": opt["feature_motion_lr"] / 20.0,
            "motion_scaling": opt["scaling_lr"], "motion_opacity": opt["opacity_motion_lr"],
            "motion_opacity_center": opt["opacity_motion_center_lr"],
            "motion_opacity_var": opt["opacity_motion_var_lr"],
            "motion_rotation": opt["rotation_motion_lr"]}


def radam(p: dict, g: dict, state: dict, lrs: dict):
    """One RAdam step (betas 0.9, 0.999, eps 1e-8): new params and state."""
    t = state["step"] + 1
    b2t = BETA2 ** t
    bias1, bias2 = 1 - BETA1 ** t, 1 - b2t
    rho_inf = 2 / (1 - BETA2) - 1
    rho = rho_inf - 2 * t * b2t / bias2
    rect = math.sqrt(max(((rho - 4) * (rho - 2) * rho_inf)
                         / ((rho_inf - 4) * (rho_inf - 2) * max(rho, 1e-6)), 0.0))
    new_p, mu, nu = {}, {}, {}
    for k in p:
        mu[k] = BETA1 * state["mu"][k] + (1 - BETA1) * g[k]
        nu[k] = BETA2 * state["nu"][k] + (1 - BETA2) * g[k] * g[k]
        m_hat = mu[k] / bias1
        upd = m_hat * rect * math.sqrt(bias2) / (torch.sqrt(nu[k]) + EPS) if rho > 5 else m_hat
        new_p[k] = p[k] - lrs[k] * upd
    return new_p, {"mu": mu, "nu": nu, "step": t}


# The statistics' names, as the program's model holds them: (static,
# dynamic) name of each accumulator.
STATS = {
    "max_radius": ("max_radii2D", "motion_max_radii2D"),
    "min_radius": ("min_radii2D", "motion_min_radii2D"),
    "grad": ("xyz_gradient_accum", "motion_xyz_gradient_accum"),
    "count": ("denom", "motion_denom"),
    "error": ("xyz_error_accum", "motion_xyz_error_mean"),
    "error_min": ("xyz_error_min", "motion_xyz_error_min"),
    "error_min_t": ("xyz_error_min_timestamp", "motion_xyz_error_min_timestamp"),
    "ssim_error": ("xyz_ssim_error_accum", "motion_xyz_ssim_error_accum"),
    "error_count": ("error_denom", "motion_error_denom"),
}


def init_stats(masks: tuple, dtype, device) -> dict:
    """Fresh statistics: least radius and least error 1000, the least
    error's frame -1, everything else 0."""
    fill = {"min_radius": 1000.0, "error_min": 1000.0, "error_min_t": -1.0}
    out = {}
    for what, names in STATS.items():
        for name, m in zip(names, masks):
            out[name] = torch.full((m.shape[0],), fill.get(what, 0.0), dtype=dtype,
                                   device=device)
    return out


def update_stats(stats: dict, masks: tuple, scr: Screen, xy_grad, weights, cam: dict,
                 t: float, iteration: int, cfg: dict) -> dict:
    """The statistics after one step: `xy_grad` [P, 2] is the loss's
    gradient by the screen-space means in pixels, `weights` [P, 3] each
    splat's summed blending weight and its weight-shared L1 and SSIM."""
    out = dict(stats)
    ndc_grad = xy_grad * torch.tensor([cam["width"] / 2.0, cam["height"] / 2.0],
                                      dtype=xy_grad.dtype, device=xy_grad.device)
    grad_norm = torch.linalg.norm(ndc_grad, dim=-1)
    ps = masks[0].shape[0]
    for side, (rows, mask) in enumerate(((slice(0, ps), masks[0]), (slice(ps, None), masks[1]))):
        n = {what: names[side] for what, names in STATS.items()}
        r, w = scr.radius[rows], weights[rows]
        seen = (scr.radius[rows] > 0) & mask
        on = seen & (iteration < cfg["densify_until_iter"])
        out[n["max_radius"]] = torch.where(on, torch.maximum(stats[n["max_radius"]], r),
                                           stats[n["max_radius"]])
        out[n["grad"]] = stats[n["grad"]] + torch.where(on, grad_norm[rows], 0.0)
        out[n["count"]] = stats[n["count"]] + on.to(r.dtype)
        if cfg["l1_accum"]:
            covered = w[:, 0] > 0
            out[n["min_radius"]] = torch.where(covered & mask,
                                               torch.minimum(stats[n["min_radius"]], r),
                                               stats[n["min_radius"]])
            l1 = w[:, 1] / torch.clamp_min(w[:, 0], 1e-4)
            ss = w[:, 2] / torch.clamp_min(w[:, 0], 1e-4)
            better = (stats[n["error_min"]] > l1) & (w[:, 0] > 0.01) & on
            out[n["error"]] = stats[n["error"]] + torch.where(on, l1, 0.0)
            out[n["error_min_t"]] = torch.where(better, float(t), stats[n["error_min_t"]])
            out[n["error_min"]] = torch.where(better, l1, stats[n["error_min"]])
            out[n["ssim_error"]] = stats[n["ssim_error"]] + torch.where(on, ss, 0.0)
            out[n["error_count"]] = stats[n["error_count"]] + (on & covered).to(r.dtype)
    return out


class StepInput(NamedTuple):
    cam: dict
    t: float
    gt: torch.Tensor  # [H, W, 3]
    bg: torch.Tensor  # [3]
    iteration: int


class StepOutput(NamedTuple):
    params: dict
    state: dict
    stats: dict
    loss: float
    grads: dict  # as RAdam takes them


def train_step(p: dict, state: dict, stats: dict, masks: tuple, scene: dict, cfg: dict,
               x: StepInput, spatial_scale: float, loss_rows=None, radam=radam) -> StepOutput:
    """One step: render, loss, gradients, RAdam on the active rows, the
    statistics of the visible splats."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    scr = project(*splats_at(leaves, masks, scene, cfg, x.t), x.cam, cfg)
    screen_leaves = [v.detach().requires_grad_(True)
                     for v in (scr.xy, scr.conic, scr.opacity, scr.rgb)]
    scr_l = scr._replace(xy=screen_leaves[0], conic=screen_leaves[1],
                         opacity=screen_leaves[2], rgb=screen_leaves[3])
    with torch.no_grad():
        img, _, acc = composite(scr_l, cfg, x.cam, x.bg)
    img = img.detach().requires_grad_(True)
    loss = image_loss(img, x.gt, cfg["lambda_dssim"], loss_rows)
    (g_img,) = torch.autograd.grad(loss, img)
    with torch.no_grad():
        # per pixel: 1, and its L1 and SSIM over its accumulated alpha
        covered = acc > 0
        share = torch.where(covered, 1.0 / torch.where(covered, acc, 1.0), 0.0)
        l1 = (img - x.gt).abs().mean(-1)
        ss = ssim_map(img.permute(2, 0, 1), x.gt.permute(2, 0, 1)).mean(0)
        pixel_weights = torch.stack([covered.to(acc.dtype), l1 * share, ss * share], -1)
    weights = composite(scr_l, cfg, x.cam, x.bg, grad_image=g_img, pixel_weights=pixel_weights)
    outs = [scr.xy, scr.conic, scr.opacity, scr.rgb]
    cots = [v.grad if v.grad is not None else torch.zeros_like(v) for v in screen_leaves]
    total = loss + regularizers(leaves, masks, cfg, x.iteration, scene["keyframe_num"])
    grads = torch.autograd.grad([total, *outs], list(leaves.values()),
                                grad_outputs=[torch.ones_like(total), *cots], allow_unused=True)
    g = {}
    for (k, v), gk in zip(leaves.items(), grads):
        gk = torch.zeros_like(v) if gk is None else gk
        mask = masks[1] if k.startswith("motion_") else masks[0]
        gk = torch.where(mask.view(-1, *([1] * (v.ndim - 1))), gk, torch.zeros_like(gk))
        g[k] = torch.nan_to_num(gk) if k == "motion_opacity_var" else gk
    new_p, new_state = radam(p, g, state, learning_rates(cfg, spatial_scale, x.iteration))
    new_stats = update_stats(stats, masks, scr, cots[0], weights, x.cam, x.t, x.iteration, cfg)
    return StepOutput({k: v.detach() for k, v in new_p.items()}, new_state, new_stats,
                      float(total.detach()), g)


def init_state(p: dict) -> dict:
    return {"mu": {k: torch.zeros_like(v) for k, v in p.items()},
            "nu": {k: torch.zeros_like(v) for k, v in p.items()}, "step": 0}
