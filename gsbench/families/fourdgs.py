"""4D Gaussian Splatting (Yang et al., ICLR 2024): one set of 4D Gaussians,
each sliced at the frame's time into a 3D Gaussian whose opacity is scaled
by its marginal in time and whose colour comes from 4D spherindrical
harmonics, rendered by 3DGS's rasterizer and trained on a batch of views a
step with L1 + SSIM and Adam.

The family's parts of the benchmark (see `families/__init__.py`): its
scene in the program's parameter layout (`ex4dgs_tpu_torch.models.state4d`),
the program's entry points (`rendering.render4d`,
`train.step.train_step_4d`), the yardstick's census, the float64 reference
(`gsbench/reference_fourdgs.py`) over the training stretches and the
frames, and the control's faults. The traffic's times are frame indices;
the family maps frame f of `frames` to the second time_duration[0] + f l /
frames of the configuration's time span l. The port is imported when a
call needs it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import reference as R
from .. import reference_fourdgs as FR
from .. import scene

VIEWS_PER_STEP = 4
SH_C0 = 0.28209479177387814


# ---------------------------------------------------------------------------
# The scene
# ---------------------------------------------------------------------------

def capacity(cfg: dict) -> int:
    """Rows as the port holds them: n_gaussians rounded up to 4096."""
    return max(4096, -(-int(cfg["n_gaussians"]) // 4096) * 4096)


def time_span(cfg: dict) -> float:
    start, end = cfg["time_duration"]
    return float(end) - float(start)


def seconds(cfg: dict, frame: float) -> float:
    """The time in seconds of frame index `frame`."""
    return float(cfg["time_duration"][0]) + float(frame) * time_span(cfg) / cfg["frames"]


def feature_rows(cfg: dict) -> int:
    return (cfg["sh_degree"] + 1) ** 2 * (cfg["sh_degree_t"] + 1)


def make_params(cfg: dict, seed: int, device, perturb: dict | None = None) -> dict:
    """The scene's parameters and mask (float32 on `device`) from `seed`,
    capacity-padded under the names of `ex4dgs_tpu_torch.models.state4d`,
    drawn from one `torch.Generator` in a few large calls.

    A Gaussian cloud of std `cloud_std` around the origin; time means
    uniform over the time span; log-uniform spatial sizes in `splat_size`
    and time sizes in `time_size` (seconds); a random 3D orientation as the
    pair (u, u with its i and j parts negated), which rotates xyz and fixes
    t, both quaternions then perturbed by N(0, `rot_mix`) so that space and
    time mix (the sliced mean moves with t); colours (DC) uniform in
    [0.05, 0.95], the other feature rows N(0, `sh_std`); opacities uniform
    in `opacity`. `perturb` (colour and opacity standard deviations) adds
    seeded noise to colours and opacities only, from a second stream of
    the same seed: the target the training cell fits."""
    dev = torch.device(device)
    P, n = capacity(cfg), cfg["n_gaussians"]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, **f32)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    def unit(q):
        return q / torch.linalg.norm(q, dim=-1, keepdim=True)

    lo_s, hi_s = (math.log(v) for v in cfg["splat_size"])
    lo_t, hi_t = (math.log(v) for v in cfg["time_size"])
    op_lo, op_hi = cfg["opacity"]
    start = float(cfg["time_duration"][0])
    p = {}
    p["xyz"] = normal(P, 3) * cfg["cloud_std"]
    p["t"] = start + uniform(0.0, 1.0, P, 1) * time_span(cfg)
    p["scaling"] = uniform(lo_s, hi_s, P, 3)
    p["scaling_t"] = uniform(lo_t, hi_t, P, 1)
    u = unit(normal(P, 4))
    flip = torch.tensor([1.0, -1.0, -1.0, 1.0], **f32)
    p["rotation"] = unit(u + cfg["rot_mix"] * normal(P, 4))
    p["rotation_r"] = unit(u * flip + cfg["rot_mix"] * normal(P, 4))
    p["opacity"] = torch.logit(uniform(op_lo, op_hi, P, 1))
    p["f_dc"] = (uniform(0.05, 0.95, P, 1, 3) - 0.5) / SH_C0
    p["f_rest"] = normal(P, feature_rows(cfg) - 1, 3) * cfg["sh_std"]
    if perturb:
        pg = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x5EED5EED)
        for key, sd in (("f_dc", perturb["color_std"]), ("opacity", perturb["opacity_std"])):
            p[key] = p[key] + sd * torch.randn(p[key].shape, generator=pg, **f32)
    mask = torch.arange(P, device=dev) < n
    for key, v in p.items():
        p[key] = torch.where(mask.view(-1, *([1] * (v.ndim - 1))), v, _empty_row(key, v))
    return {"params": p, "mask": mask, "active_sh_degree": cfg["sh_degree"],
            "active_sh_degree_t": cfg["sh_degree_t"]}


def _empty_row(key: str, v: torch.Tensor) -> torch.Tensor:
    """The value of an inactive row (state4d's empty model: identity
    quaternions, log-scales and logit -10, zeros)."""
    if key in ("scaling", "scaling_t", "opacity"):
        return torch.full_like(v, -10.0)
    if key in ("rotation", "rotation_r"):
        e = torch.zeros_like(v)
        e[..., 0] = 1.0
        return e
    return torch.zeros_like(v)


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------

class Program:
    """The port's 4D model, configs and cameras for one configuration, and
    its entry points."""

    def __init__(self, cfg: dict, device):
        from ex4dgs_tpu_torch.kernel_config import KernelConfig
        from ex4dgs_tpu_torch.models.config import (Model4DConfig, Optimization4DConfig,
                                                    overlay_json)
        from ex4dgs_tpu_torch.rendering import default_capacity

        self.cfg, self.device = cfg, torch.device(device)
        mcfg = overlay_json(Model4DConfig(), cfg)
        self.mcfg = dataclasses.replace(mcfg, time_duration=tuple(mcfg.time_duration))
        self.ocfg = overlay_json(Optimization4DConfig(), cfg)
        self.kcfg = KernelConfig(tile_x=cfg["tile"][0], tile_y=cfg["tile"][1],
                                 exact_sort=cfg["exact_sort"]).validate()
        self.capacity = default_capacity(capacity(cfg), cfg["width"], cfg["height"], self.kcfg)

    def model(self, sc: dict):
        from ex4dgs_tpu_torch.models.state4d import Gaussian4DModel, empty_stats

        i32 = dict(dtype=torch.int32, device=self.device)
        return Gaussian4DModel(params=dict(sc["params"]), mask=sc["mask"],
                               stats=empty_stats(sc["mask"].shape[0], self.device),
                               active_sh_degree=torch.tensor(sc["active_sh_degree"], **i32),
                               active_sh_degree_t=torch.tensor(sc["active_sh_degree_t"], **i32))

    def camera(self, c: dict):
        from ex4dgs_tpu_torch.rendering import RenderCamera

        return RenderCamera.from_fov(c["view"], c["proj"], c["campos"], c["width"],
                                     c["height"], c["fovx"], c["fovy"], device=self.device)

    def render(self, model, cam, t: float):
        """The frame of frame index t, with no gradient."""
        from ex4dgs_tpu_torch.rendering import render4d

        with torch.no_grad():
            return render4d(cam, model, self.mcfg, t=seconds(self.cfg, t),
                            bg=torch.zeros(3, device=self.device), capacity=self.capacity,
                            kernel_cfg=self.kcfg, device=self.device)

    def start(self, model) -> dict:
        """The training state carried from step to step: the model, fresh
        Adam state, the step's statics."""
        from ex4dgs_tpu_torch.models.optimizer import init_state
        from ex4dgs_tpu_torch.train.step import Step4DStatics, train_step_4d

        self._train_step = train_step_4d
        statics = Step4DStatics(cfg=self.mcfg, opt=self.ocfg,
                                spatial_lr_scale=scene.cameras_extent(self.cfg),
                                capacity=self.capacity, kernel=self.kcfg)
        return {"model": model, "state": init_state(model.params, device=self.device),
                "statics": statics}

    def step(self, carried: dict, cams, gts, ts, bg, iteration: int):
        """One `train_step_4d` on the views; `carried` takes its state.
        (loss, the largest view's binning total, NaN flag) as device
        tensors."""
        out = self._train_step(carried["model"], carried["state"], cams, gts,
                               [seconds(self.cfg, t) for t in ts], bg, iteration,
                               carried["statics"], device=self.device)
        carried["model"], carried["state"] = out.model, out.opt_state
        return out.loss, out.binning_total, out.nan_flag

    @staticmethod
    def snapshot(carried: dict) -> dict:
        model, state = carried["model"], carried["state"]
        return {"params": _host(model.params), "mu": _host(state.mu), "nu": _host(state.nu),
                "step": int(state.step), "stats": _host(model.stats)}

    @staticmethod
    def current(carried: dict):
        return carried["model"]


def _host(d: dict) -> dict:
    return {k: v.detach().cpu() for k, v in d.items()}


# ---------------------------------------------------------------------------
# The yardstick's census
# ---------------------------------------------------------------------------

def _model_info(cfg: dict) -> dict:
    return {"sh_degree": cfg["sh_degree"], "sh_degree_t": cfg["sh_degree_t"],
            "span": time_span(cfg)}


def census(cfg: dict, sc: dict, model, views) -> dict:
    """What one call of `model` over `views` [(host camera, frame)] asks of
    the device, by the reference in float32, summed over the views:
    (contributing, applied) pairs, tile instances, visible Gaussians,
    pixels, the active Gaussians the slicing reads; and the active
    parameter elements a step updates."""
    mask = sc["mask"]
    active = int(mask.sum())
    out = {"pairs": (0, 0), "instances": 0, "visible": 0, "pixels": 0, "gaussians": 0}
    with torch.no_grad():
        p = {k: v.float() for k, v in model.params.items()}
        for cam, frame in views:
            scr = FR.screen(p, mask, _model_info(cfg), cfg, cam, seconds(cfg, frame))
            _, pairs, _ = R.composite(scr, cfg, cam, torch.zeros(3, device=scr.xy.device))
            order, _, _ = R.tile_lists(scr, cfg, cam["width"], cam["height"])
            out = {"pairs": (out["pairs"][0] + pairs[0], out["pairs"][1] + pairs[1]),
                   "instances": out["instances"] + int(order.shape[0]),
                   "visible": out["visible"] + int(scr.valid.sum()),
                   "pixels": out["pixels"] + cam["width"] * cam["height"],
                   "gaussians": out["gaussians"] + active}
    out["param_elements"] = active * sum(v[0].numel() for v in model.params.values())
    return out


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

BETA1 = FR.BETA1
SUMS = ["xyz_gradient_accum", "denom"]
# whole pixels: a radius differs beyond rounding by half a pixel
EXTREMA = {"max_radii2D": (0.5, False)}


def _ref_scene(cfg: dict, seed: int, device, dtype, perturb=None):
    sc = make_params(cfg, seed, device, perturb=perturb)
    return {k: v.to(dtype) for k, v in sc["params"].items()}, sc["mask"]


def _dhost(d: dict) -> dict:
    return {k: v.double().cpu() for k, v in d.items()}


def reference_stretch(cfg: dict, mix: dict, seed: int, device, x: dict,
                      start: dict | None = None, first: int = 0, dtype=torch.float64,
                      views_in_loss=None, optimizer=FR.adam, **slice_fault) -> dict:
    """The reference's `checked_steps` steps of VIEWS_PER_STEP views
    computed in `dtype` from step `first` of the traffic: from the seeded
    scene with fresh Adam state and statistics, or from `start` (params,
    mu, nu, step, stats on the host). views_in_loss, optimizer and
    slice_fault are the control's faults (`faults`). Returns the losses,
    the first step's gradient, and the state at the start and after the
    steps, on the host; the parameters are stored in float32 between steps,
    as the program holds them."""
    from ..drive import backgrounds, entries

    p, mask = _ref_scene(cfg, seed, device, dtype)
    if start is None:
        state, stats = FR.init_state(p), FR.init_stats(mask, dtype, device)
    else:
        def dev(d):
            return {k: v.to(device=device, dtype=dtype) for k, v in d.items()}

        p, stats = dev(start["params"]), dev(start["stats"])
        state = {"mu": dev(start["mu"]), "nu": dev(start["nu"]), "step": int(start["step"])}
    begin = {"params": _dhost(p), "mu": _dhost(state["mu"]), "nu": _dhost(state["nu"]),
             "stats": _dhost(stats)}
    gt_p, _ = _ref_scene(cfg, seed, device, dtype, perturb=mix["perturb"])
    bgs = backgrounds(seed, mix["backgrounds"], device).to(dtype)
    zero = torch.zeros(3, dtype=dtype, device=device)
    info = _model_info(cfg)
    losses, grad1 = [], None
    for i in range(first, first + mix["checked_steps"]):
        views = []
        for e in entries(x, i):
            cam, t = x["cams"][x["pool_cam"][e]], seconds(cfg, x["pool_t"][e])
            views.append(FR.View(cam, t, FR.render(gt_p, mask, info, cfg, cam, t, zero)[0]))
        out = FR.train_step(p, state, stats, mask, info, cfg, views, bgs[i % len(bgs)],
                            mix["first_iteration"] + i, x["spatial_scale"], views_in_loss,
                            optimizer, **slice_fault)
        p, state, stats = out.params, out.state, out.stats
        if torch.finfo(dtype).bits > 32:
            p = {k: v.float().to(dtype) for k, v in p.items()}
        losses.append(out.loss)
        if grad1 is None:
            grad1 = _dhost(out.grads)
        del views, out
    return {"losses": losses, "grad1": grad1, "begin": begin,
            "after": {"params": _dhost(p), "mu": _dhost(state["mu"]), "nu": _dhost(state["nu"]),
                      "stats": _dhost(stats)}}


def reference_frames(cfg: dict, seed: int, device, views, dtype=torch.float64):
    """The reference's frame [H, W, 3] of each (host camera, frame) in
    `views`, one at a time."""
    p, mask = _ref_scene(cfg, seed, device, dtype)
    zero = torch.zeros(3, dtype=dtype, device=device)
    for cam, frame in views:
        yield FR.render(p, mask, _model_info(cfg), cfg, cam, seconds(cfg, frame), zero)[0]


# ---------------------------------------------------------------------------
# The control's faults: each the reference with the fault, in the
# program's place
# ---------------------------------------------------------------------------

def adam_nu_unfed(p, g, state, lrs, eps):
    """Adam whose stored second moment leaves out the new gradient's
    square (the update itself is Adam's)."""
    new_p, new_state = FR.adam(p, g, state, lrs, eps)
    new_state["nu"] = {k: FR.BETA2 * v for k, v in state["nu"].items()}
    return new_p, new_state


def faults(cfg: dict) -> dict:
    """{fault: reference_stretch keywords}: the opacity not scaled by the
    marginal; the sliced mean without its conditional offset; time degree
    0; one view of each step left out of the loss; the second moment
    stored without the new gradient's square."""
    return {"marginal_off": {"marginal": False}, "mean_offset_off": {"mean_offset": False},
            "time_sh_off": {"sh_degree_t": 0},
            "three_of_four_views": {"views_in_loss": VIEWS_PER_STEP - 1},
            "adam_nu_unfed": {"optimizer": adam_nu_unfed}}
