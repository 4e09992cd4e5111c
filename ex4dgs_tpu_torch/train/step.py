"""One training step: render -> loss -> backward -> RAdam -> stat accumulators.

Counterpart of `ex4dgs_tpu/train/step.py`, with the reference's two gradient
side channels as explicit zero leaves that require grad:

* densification stats: the gradient of `mean2d_offset` (zeros [P, 3] added
  to the NDC means), the reference's screen-space dummy;
* error backtracking: `sum(flow_image * hook.detach())` is added to the loss
  with hook = [acc, L1 map, SSIM map]. The flow features are blended with
  detached weights, so this term reaches only `flow_dirs`, whose gradient is
  the per-Gaussian [visibility weight, L1, SSIM] accumulation; its value is
  0, since flow_dirs is 0.

A step whose binning overflowed its capacity (the image and the gradients
come from a truncated instance list) leaves params, moments and stats as
they were; the caller grows the capacity and runs the camera again. The
gate is on the device, as the JAX step's: the update is always computed
and `torch.where(ok, new, old)` selects it tensor by tensor, so the step
reads nothing back to the host and the caller may look at binning_total
whenever it likes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import resolve_device, scalar_on, upload
from ..kernel_config import KernelConfig
from ..models.config import ModelConfig, OptimizationConfig
from ..models.optimizer import RAdamState, group_lrs, mask_grads, radam_update, scrub_nan
from ..models.state import GaussianModel
from ..ops.losses import l1_loss, psnr, ssim
from ..rendering import RenderCamera, RenderResult, render
from ..runtime.profiling import span


@dataclasses.dataclass(frozen=True)
class StepStatics:
    """The step's fixed configuration."""

    cfg: ModelConfig
    opt: OptimizationConfig
    spatial_lr_scale: float
    capacity: int  # binning instance-buffer capacity
    kernel: KernelConfig | None = None  # tile shape and sort (default 32x16)


class StepOutputs(NamedTuple):
    model: GaussianModel
    opt_state: RAdamState
    loss: torch.Tensor
    ll1: torch.Tensor
    psnr: torch.Tensor
    visibility: torch.Tensor
    binning_total: torch.Tensor
    nan_flag: torch.Tensor  # [] bool: NaN in the new xyz (or motion_xyz)


def _safe_norm(x, dim=-1):
    """Euclidean norm whose gradient at the origin is 0, not NaN."""
    sq = torch.sum(x * x, dim=dim)
    ok = sq > 0
    return torch.where(ok, torch.sqrt(torch.where(ok, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def _regularizers(params, model: GaussianModel, opt: OptimizationConfig, cfg: ModelConfig,
                  iteration: int):
    """Displacement, motion and rotation regularizers, masked to active rows
    and active keyframes; each is gated on the iteration as in the
    reference."""
    dev = model.device
    zero = torch.zeros((), device=dev)
    loss = zero
    smask = model.static_mask
    n_s = torch.clamp_min(smask.sum(), 1)
    if opt.static_reg > 0:
        gate = iteration > opt.progressive_growing_steps + opt.make_dynamic_interval
        disp_term = (torch.log(_safe_norm(params["xyz_disp"]) + 0.001) * smask).sum() / n_s
        loss = loss + torch.where(torch.full((), gate, device=dev), opt.static_reg * disp_term,
                                  zero)

    if model.dynamic_capacity > 0:
        dmask = model.dynamic_mask
        n_kf = model.keyframe_capacity
        kf_mask = (torch.arange(n_kf, dtype=torch.int32, device=dev) < model.keyframe_num)[None]
        gate = (torch.full((), iteration > opt.progressive_growing_steps * opt.extract_every
                           + opt.make_dynamic_interval, device=dev) & dmask.any())
        m = kf_mask[:, 1:] * dmask[:, None]  # [Pd, K-1]
        denom = torch.clamp_min(m.sum(), 1)
        if opt.motion_reg > 0:
            # distance of every keyframe from the first
            diff = params["motion_xyz"][:, :1] - params["motion_xyz"][:, 1:]
            dnorm = _safe_norm(diff) * m
            loss = loss + torch.where(gate, opt.motion_reg * dnorm.sum() / denom, zero)
        if opt.rot_reg > 0:
            r1 = params["motion_rotation"][:, 1:]
            r2 = params["motion_rotation"][:, :-1]
            n1 = torch.clamp_min(torch.linalg.norm(r1, dim=-1), 1e-6)
            n2 = torch.clamp_min(torch.linalg.norm(r2, dim=-1), 1e-6)
            ri = 1.0 - (r1 * r2).sum(-1) / n1 / n2
            loss = loss + torch.where(gate, opt.rot_reg * (ri * m).sum() / denom, zero)
    return loss


def _loss_and_aux(params, mean2d_offset, flow_dirs, model: GaussianModel, cam: RenderCamera,
                  gt, t, bg, iteration: int, statics: StepStatics, device=None):
    """(loss, (render result, L1)) of the model with `params`."""
    res = render(cam, model.replace(params=params), statics.cfg, t=t, bg=bg,
                 capacity=statics.capacity, mean2d_offset=mean2d_offset, flow_dirs=flow_dirs,
                 track_idx=False, kernel_cfg=statics.kernel, device=device)
    with span("ex4dgs.loss"):
        loss, ll1 = _image_loss(res, gt, statics.opt)
        loss = loss + _regularizers(params, model, statics.opt, statics.cfg, iteration)
    return loss, (res, ll1)


def _image_loss(res: RenderResult, gt, opt: OptimizationConfig):
    """(L1/SSIM loss plus the flow hook, L1) of a rendered frame."""
    img = res.render
    ll1 = l1_loss(img, gt)
    # One SSIM map serves the loss and the hook (the hook's copy is detached).
    ssim_map = ssim(img, gt, reduce=False)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim_map.mean())
    if opt.l1_accum:
        l1_map = torch.abs(img - gt).mean(dim=-1)
        hook = torch.stack([res.acc, l1_map, ssim_map.mean(dim=-1)], dim=-1).detach()
        loss = loss + (res.opticalflow * hook).sum()
    return loss, ll1


def _update_stat_accumulators(model: GaussianModel, res: RenderResult, m2d_grad, flow_grad,
                              t, iteration: int, opt: OptimizationConfig) -> GaussianModel:
    """Max/min radii, positional-gradient and L1/SSIM error accumulators."""
    stats = dict(model.stats)
    ps = model.static_capacity
    vis = res.visibility_filter
    radii = res.radii.to(torch.float32)
    densify_on = iteration < opt.densify_until_iter
    zero = torch.zeros((), device=radii.device)
    one = torch.ones((), device=radii.device)

    def upd(prefix, sl, mask_rows):
        v = vis[sl] & mask_rows
        upd_ok = v if densify_on else torch.zeros_like(v)
        r = radii[sl]
        mx = "max_radii2D" if prefix == "" else "motion_max_radii2D"
        mn = "min_radii2D" if prefix == "" else "motion_min_radii2D"
        ga = "xyz_gradient_accum" if prefix == "" else "motion_xyz_gradient_accum"
        dn = "denom" if prefix == "" else "motion_denom"
        stats[mx] = torch.where(upd_ok, torch.maximum(stats[mx], r), stats[mx])
        g2 = torch.linalg.norm(m2d_grad[sl, :2], dim=-1)
        stats[ga] = stats[ga] + torch.where(upd_ok, g2, zero)
        stats[dn] = stats[dn] + torch.where(upd_ok, one, zero)

        if opt.l1_accum:
            err = flow_grad[sl]  # [n, 3] = [visibility weight, L1, SSIM]
            err_vis = err[:, 0] > 0
            stats[mn] = torch.where(err_vis & mask_rows, torch.minimum(stats[mn], r), stats[mn])
            l1e = err[:, 1] / torch.clamp_min(err[:, 0], 1e-4)
            ssime = err[:, 2] / torch.clamp_min(err[:, 0], 1e-4)
            ea = "xyz_error_accum" if prefix == "" else "motion_xyz_error_mean"
            em = "xyz_error_min" if prefix == "" else "motion_xyz_error_min"
            et = "xyz_error_min_timestamp" if prefix == "" else "motion_xyz_error_min_timestamp"
            es = "xyz_ssim_error_accum" if prefix == "" else "motion_xyz_ssim_error_accum"
            ed = "error_denom" if prefix == "" else "motion_error_denom"
            better = (stats[em] > l1e) & (err[:, 0] > 0.01) & upd_ok
            stats[ea] = stats[ea] + torch.where(upd_ok, l1e, zero)
            stats[et] = torch.where(better, t, stats[et])
            stats[em] = torch.where(better, l1e, stats[em])
            stats[es] = stats[es] + torch.where(upd_ok, ssime, zero)
            stats[ed] = stats[ed] + torch.where(upd_ok & (err[:, 0] > 0), one, zero)

    upd("", slice(0, ps), model.static_mask)
    if model.dynamic_capacity > 0:
        upd("motion_", slice(ps, None), model.dynamic_mask)
    return model.replace(stats=stats)


def _gradients(loss, params: dict, mean2d_offset, flow_dirs):
    """(param gradients by name, mean2d_offset's, flow_dirs') of the loss;
    zeros for a leaf the loss does not reach."""
    leaves = [*params.values(), mean2d_offset, flow_dirs]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return dict(zip(params, grads[:-2])), grads[-2], grads[-1]


def _apply_update(model: GaussianModel, opt_state: RAdamState, pgrads: dict, iteration: int,
                  statics: StepStatics):
    """(model, optimizer state) after the RAdam step of the gradients
    pgrads, masked to the active rows and scrubbed of NaN."""
    pgrads = scrub_nan(mask_grads(pgrads, model))
    lrs = group_lrs(statics.opt, statics.spatial_lr_scale, iteration)
    new_params, new_state = radam_update(model.params, pgrads, opt_state, lrs)
    return model.replace(params=new_params), new_state


def _nan_flag(model: GaussianModel) -> torch.Tensor:
    flag = torch.isnan(model.params["xyz"]).any()
    if model.dynamic_capacity:
        flag = flag | torch.isnan(model.params["motion_xyz"]).any()
    return flag


def _select(ok: torch.Tensor, new, old):
    """torch.where(ok, new, old) over every tensor of two models, two
    optimizer states or two dicts of them, field by field; a tensor the
    update left as it was comes back as it is."""
    if isinstance(new, torch.Tensor):
        return new if new is old else torch.where(ok, new, old)
    if isinstance(new, dict):
        return {k: _select(ok, new[k], old[k]) for k in new}
    return dataclasses.replace(new, **{f.name: _select(ok, getattr(new, f.name),
                                                         getattr(old, f.name))
                                       for f in dataclasses.fields(new)})


def gate_update(ok: torch.Tensor, new_model: GaussianModel, model: GaussianModel,
                new_state: RAdamState, opt_state: RAdamState):
    """(model, optimizer state, NaN flag) of a step gated on the 0-d bool
    `ok` on the device: the update where ok, the inputs bit for bit where
    not, and the flag of the selected model."""
    out_model = _select(ok, new_model, model)
    out_state = _select(ok, new_state, opt_state)
    return out_model, out_state, _nan_flag(out_model)


def train_step(model: GaussianModel, opt_state: RAdamState, cam: RenderCamera, gt, t, bg,
               iteration, statics: StepStatics, device=None) -> StepOutputs:
    """One iteration on one camera at timestamp t against the image gt
    [H, W, 3], on `device` (cuda unless told otherwise; model, optimizer
    state, camera and gt must already be there). Returns the new model and
    optimizer state; on a binning overflow both come back unchanged.

    t is a host number (a 0-d tensor is taken too); bg [3] should be on
    the device already. Nothing is read back to the host: the step only
    queues work on the device."""
    with span("ex4dgs.train_step"):
        dev = resolve_device(device)
        iteration = int(iteration)
        n_total = model.static_capacity + model.dynamic_capacity
        params = {k: v.detach().requires_grad_(True) for k, v in model.params.items()}
        mean2d_offset = torch.zeros((n_total, 3), device=dev, requires_grad=True)
        flow_dirs = torch.zeros((n_total, 3), device=dev, requires_grad=True)
        t_dev = scalar_on(t, dev)
        bg = upload(bg, dev, torch.float32)

        loss, (res, ll1) = _loss_and_aux(params, mean2d_offset, flow_dirs, model, cam, gt, t,
                                         bg, iteration, statics, device=dev)
        img = res.render.detach()
        with span("ex4dgs.backward"):
            pgrads, m2d_grad, flow_grad = _gradients(loss, params, mean2d_offset, flow_dirs)
        with torch.no_grad(), span("ex4dgs.update"):
            new_model, new_state = _apply_update(model, opt_state, pgrads, iteration, statics)
            new_model = _update_stat_accumulators(new_model, res, m2d_grad, flow_grad, t_dev,
                                                  iteration, statics.opt)
            ok = res.binning_total <= statics.capacity
            out_model, out_state, nan_flag = gate_update(ok, new_model, model, new_state,
                                                         opt_state)
        return StepOutputs(model=out_model, opt_state=out_state, loss=loss.detach(),
                           ll1=ll1.detach(), psnr=psnr(img, gt),
                           visibility=res.visibility_filter,
                           binning_total=res.binning_total, nan_flag=nan_flag)
