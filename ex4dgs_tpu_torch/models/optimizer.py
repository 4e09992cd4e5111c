"""RAdam with per-parameter-group learning rates, and the LR schedules;
Adam and the rates of 4D Gaussian Splatting's recipe (`adam_update`,
`fourdgs_lrs`), whose moments are kept in the same state (`RAdamState`).

Counterpart of `ex4dgs_tpu/models/optimizer.py`: the same update as
torch.optim.RAdam (betas (0.9, 0.999), eps 1e-8, no weight decay), written
out over the capacity-padded param dict, so that density control can edit
rows of the moments (`mu`, `nu`) as it edits rows of the params. Group names
and rates are the reference's training_setup; xyz and motion_xyz follow the
log-linear exponential schedule.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from .config import Optimization4DConfig, OptimizationConfig
from .state import GaussianModel

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-8


@dataclasses.dataclass
class RAdamState:
    mu: dict  # name -> first moment (same shape as the param)
    nu: dict  # name -> second moment
    step: torch.Tensor  # [] int32, optimizer steps taken


def init_state(params: dict, device=None) -> RAdamState:
    """Zero moments and step 0 on `device` (cuda unless told otherwise),
    where the params must already be."""
    dev = resolve_device(device)
    for k, v in params.items():
        if v.device.type != dev.type:
            raise ValueError(f"param {k} is on {v.device}, the optimizer state goes on {dev}")
    return RAdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                      nu={k: torch.zeros_like(v) for k, v in params.items()},
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000):
    """Log-linear LR decay from lr_init to lr_final over max_steps, with an
    optional sine warm-up over lr_delay_steps; 0 before step 0. Float32, as
    the JAX package computes it; returns a 0-d tensor."""
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros(())
    step = torch.as_tensor(step, dtype=torch.float32).cpu()
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(torch.log(torch.tensor(lr_init, dtype=torch.float32)) * (1 - t)
                         + torch.log(torch.tensor(lr_final, dtype=torch.float32)) * t)
    return torch.where(step < 0, torch.zeros(()), delay_rate * log_lerp)


def group_lrs(opt: OptimizationConfig, spatial_lr_scale: float, iteration) -> dict:
    """Learning rate of each param group at `iteration`."""
    xyz = expon_lr(iteration, opt.position_lr_init * spatial_lr_scale,
                   opt.position_lr_final * spatial_lr_scale,
                   lr_delay_mult=opt.position_lr_delay_mult,
                   max_steps=opt.position_lr_max_steps)
    # cubic_diff tangent keyframes follow the motion_xyz schedule
    motion_xyz = expon_lr(iteration, opt.dynamic_position_lr_init * spatial_lr_scale,
                          opt.dynamic_position_lr_final * spatial_lr_scale,
                          lr_delay_mult=opt.dynamic_position_lr_delay_mult,
                          max_steps=opt.dynamic_position_lr_max_steps)
    return {
        "xyz": xyz,
        "f_dc": opt.feature_lr,
        "f_rest": opt.feature_lr / 20.0,
        "opacity": opt.opacity_lr,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
        "xyz_disp": opt.disp_lr,
        "motion_xyz": motion_xyz,
        "motion_xyz_d": motion_xyz,
        "motion_f_dc": opt.feature_motion_lr,
        "motion_f_rest": opt.feature_motion_lr / 20.0,
        "motion_scaling": opt.scaling_lr,
        "motion_opacity": opt.opacity_motion_lr,
        "motion_opacity_center": opt.opacity_motion_center_lr,
        "motion_opacity_var": opt.opacity_motion_var_lr,
        "motion_rotation": opt.rotation_motion_lr,
    }


def radam_update(params: dict, grads: dict, state: RAdamState, lrs: dict):
    """One RAdam step; returns (new params, new state). The rectified branch
    (from the 6th step on) depends only on the step count. lrs: name -> the
    group's rate (`group_lrs`' values, or their float32 bits in 0-d tensors
    on the params' device)."""
    t = (state.step + 1).to(torch.float32)
    beta2_t = torch.pow(torch.full((), BETA2, dtype=torch.float32, device=t.device), t)
    bias1 = 1.0 - torch.pow(torch.full((), BETA1, dtype=torch.float32, device=t.device), t)
    bias2 = 1.0 - beta2_t
    rho_inf = 2.0 / (1.0 - BETA2) - 1.0
    rho_t = rho_inf - 2.0 * t * beta2_t / bias2
    rect = torch.sqrt(torch.clamp_min(
        ((rho_t - 4.0) * (rho_t - 2.0) * rho_inf)
        / ((rho_inf - 4.0) * (rho_inf - 2.0) * torch.clamp_min(rho_t, 1e-6)), 0.0))
    rectified = rho_t > 5.0

    new_params, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu = BETA1 * state.mu[k] + (1.0 - BETA1) * g
        nu = BETA2 * state.nu[k] + (1.0 - BETA2) * (g * g)
        m_hat = mu / bias1
        adaptive = torch.sqrt(bias2) / (torch.sqrt(nu) + EPS)
        update = torch.where(rectified, m_hat * rect * adaptive, m_hat)
        # a rate is a host number, a 0-d CPU tensor (a scalar to any device)
        # or a 0-d tensor on the params' device, whose value a CUDA graph
        # of the step reads at each replay
        new_params[k] = p - lrs[k] * update
        new_mu[k] = mu
        new_nu[k] = nu
    return new_params, RAdamState(mu=new_mu, nu=new_nu, step=state.step + 1)


def fourdgs_lrs(opt: Optimization4DConfig, spatial_lr_scale: float, iteration) -> dict:
    """Learning rate of each of 4D Gaussian Splatting's groups at
    `iteration`: the means' xyz and t on the position schedule, the
    features, opacity, both scalings and both quaternions at fixed rates."""
    xyz = expon_lr(iteration, opt.position_lr_init * spatial_lr_scale,
                   opt.position_lr_final * spatial_lr_scale,
                   lr_delay_mult=opt.position_lr_delay_mult, max_steps=opt.position_lr_max_steps)
    return {"xyz": xyz, "t": xyz, "scaling": opt.scaling_lr, "scaling_t": opt.scaling_lr,
            "rotation": opt.rotation_lr, "rotation_r": opt.rotation_lr,
            "opacity": opt.opacity_lr, "f_dc": opt.feature_lr, "f_rest": opt.feature_lr / 20.0}


def adam_update(params: dict, grads: dict, state: RAdamState, lrs: dict, eps: float):
    """One Adam step (torch.optim.Adam's: betas (0.9, 0.999), no weight
    decay, bias-corrected); returns (new params, new state). lrs as
    radam_update takes them."""
    t = (state.step + 1).to(torch.float32)
    bias1 = 1.0 - torch.pow(torch.full((), BETA1, dtype=torch.float32, device=t.device), t)
    bias2 = 1.0 - torch.pow(torch.full((), BETA2, dtype=torch.float32, device=t.device), t)
    root2 = torch.sqrt(bias2)
    new_params, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu = BETA1 * state.mu[k] + (1.0 - BETA1) * g
        nu = BETA2 * state.nu[k] + (1.0 - BETA2) * (g * g)
        # a host rate becomes the float32 a staged one holds (a float over
        # a tensor would be the tensor's reciprocal times the float)
        lr = lrs[k] if isinstance(lrs[k], torch.Tensor) else torch.tensor(lrs[k],
                                                                          dtype=torch.float32)
        new_params[k] = p - (lr / bias1) * (mu / (torch.sqrt(nu) / root2 + eps))
        new_mu[k] = mu
        new_nu[k] = nu
    return new_params, RAdamState(mu=new_mu, nu=new_nu, step=state.step + 1)


def mask_grads(grads: dict, model: GaussianModel) -> dict:
    """Zero the gradients of inactive capacity rows, with where and not a
    product, so that NaN or inf on a padding row is killed too."""
    out = {}
    for k, g in grads.items():
        m = model.dynamic_mask if k.startswith("motion_") else model.static_mask
        mb = m.reshape((-1,) + (1,) * (g.ndim - 1))
        out[k] = torch.where(mb, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return out


def scrub_nan(grads: dict) -> dict:
    """nan_to_num on the temporal-opacity variance gradient."""
    out = dict(grads)
    out["motion_opacity_var"] = torch.nan_to_num(grads["motion_opacity_var"])
    return out
