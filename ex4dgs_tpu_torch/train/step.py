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

On CUDA the step runs as one CUDA graph. The first call with a key runs
eagerly (the warm-up), the second captures the step and replays it, every
later call stages its inputs into the graph's static buffers and replays
it. The key is what a capture bakes in: the statics, the branches the
iteration decides on the host (`iteration_gates`), the camera's size, the
inputs' shapes and the storage of every tensor of the model and optimizer
state. The timestamp and the learning rates are staged on the device each
call (`runtime/graphs.py::stage_scalars`), so the temporal query gathers
its keyframes there.
The model and optimizer state are updated in place (the gated result is
written back into their tensors), eagerly and in the graph alike, so the
state is never held twice; the small outputs are fresh tensors each call.
One step graph is kept per card: a new key releases the old graph and its
memory, and the card's render graph too. On the CPU the step runs eagerly
and returns new state.

`train_step_4d` is the step of the second model family, 4D Gaussian
Splatting (Yang et al.): a batch of views, each rendered at its own time,
the mean of their losses, one backward and Adam. It runs as one CUDA graph
through the same machinery (`_run_graphed`, on `runtime/graphs.py`), its
key (`_graph_key_4d`) holding the number and sizes of the views.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import resolve_device, scalar_on, upload
from ..kernel_config import KernelConfig
from ..models.config import Model4DConfig, ModelConfig, Optimization4DConfig, OptimizationConfig
from ..models.optimizer import (RAdamState, adam_update, fourdgs_lrs, group_lrs, mask_grads,
                                radam_update, scrub_nan)
from ..models.state import GaussianModel
from ..models.state4d import Gaussian4DModel
from ..ops.losses import combined_loss, l1_loss, psnr, ssim
from ..rendering import RenderCamera, RenderResult, render, render4d
from ..runtime import graphs
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


class Gates(NamedTuple):
    """The branches of the step that its iteration decides on the host."""

    densify: bool  # the densification stats accumulate
    static_reg: bool  # the displacement regularizer is on
    dynamic_reg: bool  # the motion and rotation regularizers are on


def iteration_gates(opt: OptimizationConfig, iteration: int) -> Gates:
    return Gates(densify=iteration < opt.densify_until_iter,
                 static_reg=iteration > opt.progressive_growing_steps + opt.make_dynamic_interval,
                 dynamic_reg=iteration > (opt.progressive_growing_steps * opt.extract_every
                                          + opt.make_dynamic_interval))


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
    gates = iteration_gates(opt, iteration)
    zero = torch.zeros((), device=dev)
    loss = zero
    smask = model.static_mask
    n_s = torch.clamp_min(smask.sum(), 1)
    if opt.static_reg > 0:
        disp_term = (torch.log(_safe_norm(params["xyz_disp"]) + 0.001) * smask).sum() / n_s
        loss = loss + torch.where(torch.full((), gates.static_reg, device=dev),
                                  opt.static_reg * disp_term, zero)

    if model.dynamic_capacity > 0:
        dmask = model.dynamic_mask
        n_kf = model.keyframe_capacity
        kf_mask = (torch.arange(n_kf, dtype=torch.int32, device=dev) < model.keyframe_num)[None]
        gate = torch.full((), gates.dynamic_reg, device=dev) & dmask.any()
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
    densify_on = iteration_gates(opt, iteration).densify
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


def _apply_update(model: GaussianModel, opt_state: RAdamState, pgrads: dict, lrs: dict):
    """(model, optimizer state) after the RAdam step of the gradients
    pgrads, masked to the active rows and scrubbed of NaN, at the rates lrs
    (as radam_update takes them)."""
    pgrads = scrub_nan(mask_grads(pgrads, model))
    new_params, new_state = radam_update(model.params, pgrads, opt_state, lrs)
    return model.replace(params=new_params), new_state


def _nan_flag(model: GaussianModel) -> torch.Tensor:
    flag = torch.isnan(model.params["xyz"]).any()
    if model.dynamic_capacity:
        flag = flag | torch.isnan(model.params["motion_xyz"]).any()
    return flag


def _select(ok: torch.Tensor, new, old, in_place: bool):
    """torch.where(ok, new, old) over every tensor of two models, two
    optimizer states or two dicts of them, field by field, written into old's
    tensors when in_place; a tensor the update left as it was comes back as
    it is."""
    if isinstance(new, torch.Tensor):
        if new is old:
            return new
        return torch.where(ok, new, old, out=old) if in_place else torch.where(ok, new, old)
    if isinstance(new, dict):
        return {k: _select(ok, new[k], old[k], in_place) for k in new}
    return dataclasses.replace(new, **{f.name: _select(ok, getattr(new, f.name),
                                                         getattr(old, f.name), in_place)
                                       for f in dataclasses.fields(new)})


def gate_update(ok: torch.Tensor, new_model: GaussianModel, model: GaussianModel,
                new_state: RAdamState, opt_state: RAdamState, in_place: bool = False):
    """(model, optimizer state, NaN flag) of a step gated on the 0-d bool
    `ok` on the device: the update where ok, the inputs bit for bit where
    not, and the flag of the selected model. in_place writes the selection
    into model's and opt_state's own tensors, which come back."""
    out_model = _select(ok, new_model, model, in_place)
    out_state = _select(ok, new_state, opt_state, in_place)
    return out_model, out_state, _nan_flag(out_model)


def clone_state(model: GaussianModel, opt_state: RAdamState):
    """Copies of a model and its optimizer state, for a caller that keeps
    them across a train_step (which updates its state in place on CUDA)."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        return dataclasses.replace(x, **{f.name: copy(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return copy(model), copy(opt_state)


def _step(model: GaussianModel, opt_state: RAdamState, cam: RenderCamera, gt, t, t_dev, bg,
          iteration: int, lrs: dict, statics: StepStatics, dev, in_place: bool) -> StepOutputs:
    """The step's work on `dev`, run eagerly or under a graph's capture. t
    is the timestamp as render takes it (a host number, or t_dev, its 0-d
    tensor on dev), lrs the rates as radam_update takes them; in_place as
    gate_update takes it."""
    n_total = model.static_capacity + model.dynamic_capacity
    params = {k: v.detach().requires_grad_(True) for k, v in model.params.items()}
    mean2d_offset = torch.zeros((n_total, 3), device=dev, requires_grad=True)
    flow_dirs = torch.zeros((n_total, 3), device=dev, requires_grad=True)

    loss, (res, ll1) = _loss_and_aux(params, mean2d_offset, flow_dirs, model, cam, gt, t, bg,
                                     iteration, statics, device=dev)
    img = res.render.detach()
    with span("ex4dgs.backward"):
        pgrads, m2d_grad, flow_grad = _gradients(loss, params, mean2d_offset, flow_dirs)
    with torch.no_grad(), span("ex4dgs.update"):
        new_model, new_state = _apply_update(model, opt_state, pgrads, lrs)
        new_model = _update_stat_accumulators(new_model, res, m2d_grad, flow_grad, t_dev,
                                              iteration, statics.opt)
        ok = res.binning_total <= statics.capacity
        out_model, out_state, nan_flag = gate_update(ok, new_model, model, new_state, opt_state,
                                                     in_place=in_place)
    return StepOutputs(model=out_model, opt_state=out_state, loss=loss.detach(),
                       ll1=ll1.detach(), psnr=psnr(img, gt), visibility=res.visibility_filter,
                       binning_total=res.binning_total, nan_flag=nan_flag)


def train_step(model: GaussianModel, opt_state: RAdamState, cam: RenderCamera, gt, t, bg,
               iteration, statics: StepStatics, device=None) -> StepOutputs:
    """One iteration on one camera at timestamp t against the image gt
    [H, W, 3], on `device` (cuda unless told otherwise; model, optimizer
    state, camera and gt must already be there). Returns the new model and
    optimizer state; on a binning overflow both come back unchanged.

    t is a host number or a 0-d tensor; bg [3] should be on the device
    already. Nothing is read back to the host: the step only queues work on
    the device.

    On CUDA the state passed in is reused for the result: its tensors are
    updated in place, by the eager call and by a graph's replay alike (see
    the module docstring), and the returned model and optimizer state hold
    those same tensors. A caller that keeps the state it passes across the
    call copies it first (`clone_state`). loss, ll1, psnr, visibility,
    binning_total and nan_flag are new tensors each call."""
    with span("ex4dgs.train_step"):
        dev = resolve_device(device)
        iteration = int(iteration)
        lrs = group_lrs(statics.opt, statics.spatial_lr_scale, iteration)
        bg = upload(bg, dev, torch.float32)
        if dev.type != "cuda":
            return _step(model, opt_state, cam, gt, t, scalar_on(t, dev), bg, iteration, lrs,
                         statics, dev, in_place=False)
        return _graphed_step(model, opt_state, cam, gt, t, bg, iteration, lrs, statics, dev)


# ---------------------------------------------------------------------------
# the step as a CUDA graph
# ---------------------------------------------------------------------------

def _graph_key(model, opt_state, cam, gt, bg, iteration, statics) -> tuple:
    inputs = [getattr(cam, f) for f in graphs.CAMERA_TENSORS] + [gt, bg]
    return (statics, iteration_gates(statics.opt, iteration), cam.width, cam.height,
            tuple((x.device, x.dtype, x.shape) for x in inputs),
            graphs.state_key(model), graphs.state_key(opt_state))


def _rates(scalars: torch.Tensor, lrs: dict, first: int = 1) -> dict:
    """The rates as staged after the `first` times."""
    return {name: scalars[i] for i, name in enumerate(lrs, first)}


def _graphed_step(model, opt_state, cam, gt, t, bg, iteration: int, lrs: dict,
                  statics: StepStatics, dev: torch.device) -> StepOutputs:
    dev = graphs.card(dev)
    key = _graph_key(model, opt_state, cam, gt, bg, iteration, statics)

    def body(inputs, scalars):
        c = dataclasses.replace(cam, **dict(zip(graphs.CAMERA_TENSORS, inputs)))
        return _step(model, opt_state, c, inputs[-2], scalars[0], scalars[0], inputs[-1],
                     iteration, _rates(scalars, lrs), statics, dev, in_place=True)

    def small(o: StepOutputs) -> StepOutputs:
        return StepOutputs(model=model, opt_state=opt_state, loss=o.loss.clone(),
                           ll1=o.ll1.clone(), psnr=o.psnr.clone(),
                           visibility=o.visibility.clone(),
                           binning_total=o.binning_total.clone(), nan_flag=o.nan_flag.clone())

    inputs = [getattr(cam, f) for f in graphs.CAMERA_TENSORS] + [gt, bg]
    return _run_graphed(dev, key, inputs, [t], lrs, body, small)


def _run_graphed(dev: torch.device, key: tuple, inputs: list, ts: list, lrs: dict, body, small):
    """A step as one CUDA graph on the card `dev` (`graphs.run`, entry
    "train_step"), shared by train_step and train_step_4d: the graph keeps
    the small outputs (model and state are the caller's), small(outputs)
    gives a replay's result, and a new key releases the card's render graph
    too."""
    return graphs.run("train_step", dev, key, inputs, ts, lrs, body, small,
                      kept=lambda out: out._replace(model=None, opt_state=None),
                      releases=("render",))


# ---------------------------------------------------------------------------
# 4D Gaussian Splatting (Yang et al.): a batch of views, Adam
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Step4DStatics:
    """train_step_4d's fixed configuration."""

    cfg: Model4DConfig
    opt: Optimization4DConfig
    spatial_lr_scale: float
    capacity: int  # binning instance-buffer capacity of each view
    kernel: KernelConfig | None = None  # tile shape and sort (default 32x16)


class Step4DOutputs(NamedTuple):
    model: Gaussian4DModel
    opt_state: RAdamState  # Adam's moments and step
    loss: torch.Tensor  # [] the mean of the views' losses
    visibility: torch.Tensor  # [P] bool: visible in some view
    binning_total: torch.Tensor  # [] int32: the largest view's instance count
    nan_flag: torch.Tensor  # [] bool: NaN in the new xyz


def _update_stats_4d(model: Gaussian4DModel, radii, m2d_grad, densify: bool) -> Gaussian4DModel:
    """The densification statistics of one batch: where a Gaussian was
    visible in some view, its largest screen radius over the views, the
    norm of its screen-space mean's gradient summed over the views, and a
    count of one."""
    stats = dict(model.stats)
    radius = torch.stack(radii).amax(0).to(torch.float32)
    on = (radius > 0) & model.mask
    if not densify:
        on = torch.zeros_like(on)
    zero = torch.zeros((), device=radius.device)
    stats["max_radii2D"] = torch.where(on, torch.maximum(stats["max_radii2D"], radius),
                                       stats["max_radii2D"])
    stats["xyz_gradient_accum"] = stats["xyz_gradient_accum"] + torch.where(
        on, torch.linalg.norm(m2d_grad[:, :2], dim=-1), zero)
    stats["denom"] = stats["denom"] + torch.where(on, torch.ones((), device=radius.device), zero)
    return model.replace(stats=stats)


def _step4d(model: Gaussian4DModel, opt_state: RAdamState, cams: list, gts: list, ts: list, bg,
            iteration: int, lrs: dict, statics: Step4DStatics, dev,
            in_place: bool) -> Step4DOutputs:
    """train_step_4d's work on `dev`, run eagerly or under a graph's
    capture: ts and lrs as render4d and adam_update take them."""
    params = {k: v.detach().requires_grad_(True) for k, v in model.params.items()}
    # one screen-space hook for every view: its gradient is the views' sum
    mean2d_offset = torch.zeros((model.capacity, 3), device=dev, requires_grad=True)
    current = model.replace(params=params)
    losses, radii, totals = [], [], []
    for cam, gt, t in zip(cams, gts, ts):
        res = render4d(cam, current, statics.cfg, t=t, bg=bg, capacity=statics.capacity,
                       mean2d_offset=mean2d_offset, kernel_cfg=statics.kernel, device=dev)
        with span("ex4dgs.loss"):
            losses.append(combined_loss(res.render, gt, statics.opt.lambda_dssim)[0])
        radii.append(res.radii)
        totals.append(res.binning_total)
    loss = torch.stack(losses).mean()
    with span("ex4dgs.backward"):
        leaves = [*params.values(), mean2d_offset]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    with torch.no_grad(), span("ex4dgs.update"):
        mask = model.mask
        pgrads = {}
        for (k, p), g in zip(params.items(), grads):
            mb = mask.view(-1, *([1] * (p.ndim - 1)))
            g = torch.where(mb, g, torch.zeros((), device=dev))
            pgrads[k] = torch.where(torch.isnan(g), torch.zeros((), device=dev), g)
        new_params, new_state = adam_update(model.params, pgrads, opt_state, lrs,
                                            statics.opt.adam_eps)
        new_model = _update_stats_4d(model.replace(params=new_params), radii, grads[-1],
                                     iteration < statics.opt.densify_until_iter)
        total = torch.stack(totals).amax()
        ok = total <= statics.capacity
        out_model = _select(ok, new_model, model, in_place)
        out_state = _select(ok, new_state, opt_state, in_place)
        visible = torch.stack(radii).amax(0) > 0
    return Step4DOutputs(model=out_model, opt_state=out_state, loss=loss.detach(),
                         visibility=visible, binning_total=total,
                         nan_flag=torch.isnan(out_model.params["xyz"]).any())


def train_step_4d(model: Gaussian4DModel, adam_state: RAdamState, cams, gts, ts, bg, iteration,
                  statics: Step4DStatics, device=None) -> Step4DOutputs:
    """One iteration of 4D Gaussian Splatting's recipe on the views
    (cams[i], gts[i] [H, W, 3], ts[i] in seconds), all of one size: each
    view rendered at its own time (`render4d`), the mean of the views'
    (1 - l) L1 + l (1 - SSIM) losses, one backward, Adam over every group
    at its scheduled rate (inactive rows' and NaN gradients zeroed), and
    the batch's densification statistics. A step in which some view's
    binning overflowed the capacity leaves model and Adam state as they
    were (the gate is on the device: nothing is read back to the host).

    On CUDA it is one CUDA graph, as train_step, through the same
    machinery (`_run_graphed`): the state passed in is updated in place and
    returned; the views' cameras and images, bg, the times and the rates
    are staged into the graph's inputs. On the CPU it runs eagerly and
    returns new state."""
    with span("ex4dgs.train_step"):
        dev = resolve_device(device)
        iteration = int(iteration)
        cams, gts, ts = list(cams), list(gts), list(ts)
        if not len(cams) == len(gts) == len(ts) > 0:
            raise ValueError(f"{len(cams)} cameras, {len(gts)} images and {len(ts)} times: "
                             "one of each per view")
        lrs = fourdgs_lrs(statics.opt, statics.spatial_lr_scale, iteration)
        bg = upload(bg, dev, torch.float32)
        if dev.type != "cuda":
            return _step4d(model, adam_state, cams, gts, ts, bg, iteration, lrs, statics, dev,
                           in_place=False)
        dev = graphs.card(dev)
        key = _graph_key_4d(model, adam_state, cams, gts, bg, iteration, statics)
        n = len(cams)

        def body(inputs, scalars):
            k = len(graphs.CAMERA_TENSORS)
            views = [dataclasses.replace(c, **dict(zip(graphs.CAMERA_TENSORS,
                                                       inputs[k * i:k * i + k])))
                     for i, c in enumerate(cams)]
            images = inputs[k * n:k * n + n]
            return _step4d(model, adam_state, views, images, [scalars[i] for i in range(n)],
                           inputs[-1], iteration, _rates(scalars, lrs, first=n), statics, dev,
                           in_place=True)

        def small(o: Step4DOutputs) -> Step4DOutputs:
            return Step4DOutputs(model=model, opt_state=adam_state, loss=o.loss.clone(),
                                 visibility=o.visibility.clone(),
                                 binning_total=o.binning_total.clone(),
                                 nan_flag=o.nan_flag.clone())

        inputs = [getattr(c, f) for c in cams for f in graphs.CAMERA_TENSORS] + gts + [bg]
        return _run_graphed(dev, key, inputs, ts, lrs, body, small)


def _graph_key_4d(model, adam_state, cams, gts, bg, iteration, statics) -> tuple:
    """What a capture of train_step_4d bakes in: the statics, whether the
    statistics accumulate, the number and sizes of the views, the inputs'
    shapes and the storage of every tensor of the model and Adam state."""
    inputs = [getattr(c, f) for c in cams for f in graphs.CAMERA_TENSORS] + list(gts) + [bg]
    return (statics, iteration < statics.opt.densify_until_iter, len(cams),
            tuple((c.width, c.height) for c in cams),
            tuple((x.device, x.dtype, x.shape) for x in inputs),
            graphs.state_key(model), graphs.state_key(adam_state))
