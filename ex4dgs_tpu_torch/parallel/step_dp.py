"""The training step sharded over a (data, gauss) mesh of ranks.

Counterpart of `ex4dgs_tpu/parallel/step_dp.py`, term for term, with
`torch.distributed` collectives (parallel/collectives.py) in place of
shard_map's:

  * data axis: each data rank differentiates its own camera; the parameter
    gradients are summed over gauss, then averaged over data, before the
    RAdam step that every rank takes on its replica of the model;
  * gauss axis: the per-Gaussian preprocess (temporal query slice,
    covariance, projection, SH) runs on a 1/G slice of the splats per gauss
    rank, the projected rows are all-gathered, and with G > 1 the
    compositing runs on one slab of tile rows per gauss rank
    (rendering.composite_projected_sharded).

The per-Gaussian statistic increments are gathered over data and folded in
data order, so D cameras per step accumulate exactly like D reference
iterations in a row. At mesh (1, 1) the step is `train_step`'s arithmetic,
bit for bit.

The overflow gate is on the device, as the JAX step's: every rank takes
the MAX of binning_total over the job, always runs the backward and the
gradient all-reduces (so every rank issues the same collectives), and
selects the update or its inputs with torch.where on that MAX, so all
ranks select alike and nothing is read back to the host. Every rank takes
the same RAdam step from the same all-reduced gradient, so the ranks'
models stay bit-equal (parallel/collectives.py).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import resolve_device, scalar_on, upload
from ..models.optimizer import RAdamState, group_lrs
from ..models.state import GaussianModel
from ..models.temporal import point_data_at_t
from ..ops.losses import psnr
from ..ops.projection import Projected
from ..rendering import (RenderCamera, composite_projected, composite_projected_sharded,
                         preprocess_points)
from ..train.step import (StepStatics, _apply_update, _gradients, _image_loss, _regularizers,
                          _update_stat_accumulators, gate_update)
from .collectives import all_gather, broadcast_, gather_rows, group_max, group_sum
from .mesh import Mesh


class ShardedStepOutputs(NamedTuple):
    model: GaussianModel
    opt_state: RAdamState
    loss: torch.Tensor  # [] mean over the data ranks
    psnr: torch.Tensor
    binning_total: torch.Tensor  # [] int32 the largest instance count over the job
    nan_flag: torch.Tensor  # [] bool, as train/step.py's StepOutputs.nan_flag


def _sliced_loss(params, mean2d_offset, flow_dirs, model: GaussianModel, cam: RenderCamera,
                 gt, t, bg, iteration: int, statics: StepStatics, mesh: Mesh):
    """(loss, (render result, L1, displayed loss)) of this rank's camera
    with the preprocess sharded over gauss and, for G > 1, the tile grid
    too. mean2d_offset and flow_dirs are this rank's rows [P/G, 3]; their
    gradients come back for those rows only."""
    cfg, opt, G = statics.cfg, statics.opt, mesh.gauss
    pts = point_data_at_t(model.replace(params=params), cfg, t, mode=0)
    p_total = pts.means3d.shape[0]
    # JAX slices p_total // G rows per rank and silently drops the rest.
    if p_total % G:
        raise ValueError(f"{p_total} point rows do not divide over gauss = {G}")
    shard = p_total // G
    rows = slice(mesh.gauss_index * shard, (mesh.gauss_index + 1) * shard)
    local = pts._replace(means3d=pts.means3d[rows], rotations=pts.rotations[rows],
                         scales=pts.scales[rows], opacity=pts.opacity[rows],
                         features=pts.features[rows], mask=pts.mask[rows])
    proj_l, colors_l = preprocess_points(local, cam, cfg, near=cfg.near, far=cfg.far,
                                         mean2d_offset=mean2d_offset, kernel_cfg=statics.kernel)
    # The whole projected set on every gauss rank; each rank's rows feed
    # its own slab, so the gradient sums over the group (GatherRows).
    gather = functools.partial(gather_rows, group=mesh.gauss_group)
    proj = Projected(*(gather(a) for a in proj_l))
    colors, flow_full = gather(colors_l), gather(flow_dirs)
    kw = dict(bg=bg, far=cfg.far, capacity=statics.capacity, static_num=pts.static_num,
              track_idx=False, kernel_cfg=statics.kernel)
    if G > 1:
        res = composite_projected_sharded(proj, colors, flow_full, cam,
                                          group=mesh.gauss_group, **kw)
    else:
        res = composite_projected(proj, colors, flow_full, cam, **kw)
    loss, ll1 = _image_loss(res, gt, opt)
    # Every gauss rank evaluates the whole regularizers and the gradients
    # are summed over gauss: scale them by 1/G so the sum counts them once.
    # The render-loss gradients are per-slice, so their sum is the whole.
    reg = _regularizers(params, model, opt, cfg, iteration)
    return loss + reg / G, (res, ll1, loss + reg)


def make_sharded_train_step(statics: StepStatics, mesh: Mesh, device=None):
    """The step of this rank of `mesh` on `device` (cuda unless told
    otherwise; the mesh's device must be of that type):

        step(model, opt_state, cam, gt, t, bg, iteration) -> ShardedStepOutputs

    model and opt_state replicated (the same bits on every rank; see
    `replicate`), cam, gt [H, W, 3] and t this rank's camera (its data
    index's entry of the step's camera batch; see `shard_data`; t a host
    number, as train_step takes it). Every rank of the mesh must call it
    with the same iteration. On a binning overflow anywhere in the job every
    rank returns its model and state unchanged."""
    dev = resolve_device(device)
    if dev.type != mesh.device.type:
        raise ValueError(f"the step runs on {dev}, the mesh on {mesh.device}")
    D, G = mesh.data, mesh.gauss

    def step(model: GaussianModel, opt_state: RAdamState, cam: RenderCamera, gt, t, bg,
             iteration) -> ShardedStepOutputs:
        iteration = int(iteration)
        n_total = model.static_capacity + model.dynamic_capacity
        shard = n_total // G
        params = {k: v.detach().requires_grad_(True) for k, v in model.params.items()}
        m2d_local = torch.zeros((shard, 3), device=mesh.device, requires_grad=True)
        flow_local = torch.zeros((shard, 3), device=mesh.device, requires_grad=True)
        t_dev = scalar_on(t, mesh.device)
        bg = upload(bg, mesh.device, torch.float32)

        loss, (res, _ll1, loss_display) = _sliced_loss(
            params, m2d_local, flow_local, model, cam, gt, t, bg, iteration, statics, mesh)
        img = res.render.detach()
        loss_mean = group_sum(loss_display.detach(), mesh.data_group) / D
        psnr_mean = group_sum(psnr(img, gt), mesh.data_group) / D
        # The gate: res.binning_total is already the worst slab's over gauss;
        # the MAX over the job says whether ANY camera overflowed.
        binning_total = group_max(res.binning_total)

        pgrads, m2d_grad, flow_grad = _gradients(loss, params, m2d_local, flow_local)
        with torch.no_grad():
            # The sum over gauss reassembles the sliced backward, the mean
            # over data is the data-parallel gradient: one flat buffer and
            # one all-reduce for each axis of more than one rank.
            if D * G > 1:
                flat = torch.cat([g.reshape(-1) for g in pgrads.values()])
                flat = group_sum(group_sum(flat, mesh.gauss_group), mesh.data_group) / D
                at = 0
                for k, g in pgrads.items():
                    pgrads[k] = flat[at:at + g.numel()].view_as(g)
                    at += g.numel()
            lrs = group_lrs(statics.opt, statics.spatial_lr_scale, iteration)
            new_model, new_state = _apply_update(model, opt_state, pgrads, lrs)

            # The stat side channel: the whole per-Gaussian rows (gathered
            # over gauss), then one camera at a time in data order. radii
            # and visibility come from the gathered projection: whole on
            # every rank.
            m2d_full = torch.cat(all_gather(m2d_grad, mesh.gauss_group))
            flow_full = torch.cat(all_gather(flow_grad, mesh.gauss_group))
            per_cam = [all_gather(x, mesh.data_group)
                       for x in (res.radii, res.visibility_filter, m2d_full, flow_full, t_dev)]
            for radii, vis, m2d, flow, t_d in zip(*per_cam):
                res_d = res._replace(radii=radii, visibility_filter=vis)
                new_model = _update_stat_accumulators(new_model, res_d, m2d, flow, t_d,
                                                      iteration, statics.opt)
            out_model, out_state, nan_flag = gate_update(
                binning_total <= statics.capacity, new_model, model, new_state, opt_state)
        return ShardedStepOutputs(model=out_model, opt_state=out_state, loss=loss_mean,
                                  psnr=psnr_mean, binning_total=binning_total,
                                  nan_flag=nan_flag)

    return step


def _tensors(tree):
    """Every tensor of a model, an optimizer state or a dict of them, in a
    fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (GaussianModel, RAdamState)):
        for name in sorted(vars(tree)):
            yield from _tensors(getattr(tree, name))


def replicate(tree, mesh: Mesh):
    """Give every rank rank 0's bits of a model or optimizer state (its
    tensors are overwritten in place), as JAX's replicate lays one value on
    every device. Returns the tree."""
    for t in _tensors(tree):
        broadcast_(t, src=0)
    return tree


def shard_data(items: list, mesh: Mesh):
    """This rank's entry of a step's per-camera list (one per data index),
    as JAX's shard_data gives each data row its slice."""
    if len(items) != mesh.data:
        raise ValueError(f"{len(items)} entries for a data axis of {mesh.data}")
    return items[mesh.data_index]
