"""Ex4DGS (Lee et al., NeurIPS 2024): a static cloud whose splats drift
linearly over the duration, and dynamic splats keyframed in position and
rotation with a visibility window, rendered by EWA splatting and trained
with L1 + SSIM and RAdam, one view a step.

The family's parts of the benchmark (see `families/__init__.py`): its
scene in the program's parameter layout, the program's entry points
(`ex4dgs_tpu_torch`: `rendering.render`, `train.step.train_step`), the
yardstick's census and the float64 reference (`gsbench/reference.py`) over
the training stretches and the frames, and the control's faults. The port
is imported when a call needs it (`train_step` when training starts), so
that a test's patch of an entry point, made before the run, reaches the
timed path.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import reference as R
from .. import scene

VIEWS_PER_STEP = 1
SH_C0 = 0.28209479177387814


# ---------------------------------------------------------------------------
# The scene
# ---------------------------------------------------------------------------

def _round_up(n: int, granularity: int) -> int:
    return max(granularity, -(-int(n) // granularity) * granularity)


def capacities(cfg: dict) -> tuple[int, int]:
    """(static, dynamic) row capacities as the trainer holds them: rounded
    up to 4096 and 1024 rows."""
    return _round_up(cfg["n_static"], 4096), _round_up(cfg["n_dynamic"], 1024)


def time_shift(cfg: dict) -> int:
    """time_pad, plus one interval for the four-point interpolators."""
    if cfg["interp_type"] in ("cube", "pchip"):
        return cfg["time_pad"] + cfg["time_interval"]
    return cfg["time_pad"]


def keyframes(cfg: dict) -> int:
    """Keyframes for the whole duration, as the trainer sizes them
    (`required_keyframes(duration + time_shift)`)."""
    shift = time_shift(cfg)
    dur = cfg["frames"] + shift
    return math.ceil((dur + shift + cfg["time_pad"] * 2 + 1) / cfg["time_interval"]) + 3


def make_params(cfg: dict, seed: int, device, perturb: dict | None = None) -> dict:
    """The scene's parameters and masks (float32 on `device`) from `seed`:
    capacity-padded static and dynamic splats under the names of
    `ex4dgs_tpu_torch.models.state`, drawn from one `torch.Generator` in a
    few large calls.

    Static splats: a Gaussian cloud of std `cloud_std` around the origin,
    log-uniform sizes in `splat_size`, random unit quaternions, colours
    (DC) uniform in [0.05, 0.95], higher SH bands N(0, `sh_std`), opacities
    uniform in `opacity`, a small per-splat displacement over the duration.
    Dynamic splats: the same, moving on smooth per-keyframe orbits, with
    slowly turning rotations and a seeded visibility window. `perturb`
    (colour and opacity standard deviations) adds seeded noise to colours
    and opacities only, from a second stream of the same seed: the target
    the training cell fits."""
    dev = torch.device(device)
    ps, pd = capacities(cfg)
    ns, nd = cfg["n_static"], cfg["n_dynamic"]
    k = keyframes(cfg)
    n_rest = (cfg["sh_degree"] + 1) ** 2 - 1
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, **f32)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    std = cfg["cloud_std"]
    lo_s, hi_s = (math.log(v) for v in cfg["splat_size"])
    op_lo, op_hi = cfg["opacity"]

    def logit(p):
        return torch.log(p / (1.0 - p))

    def quats(*shape):
        q = normal(*shape, 4)
        return q / torch.linalg.norm(q, dim=-1, keepdim=True)

    p = {}
    p["xyz"] = normal(ps, 3) * std
    p["f_dc"] = ((uniform(0.05, 0.95, ps, 1, 3)) - 0.5) / SH_C0
    p["f_rest"] = normal(ps, n_rest, 3) * cfg["sh_std"]
    p["opacity"] = logit(uniform(op_lo, op_hi, ps, 1))
    p["scaling"] = uniform(lo_s, hi_s, ps, 3)
    p["rotation"] = quats(ps)
    p["xyz_disp"] = normal(ps, 3) * cfg["disp_std"]

    # Dynamic splats: centre + an orbit of radius `orbit` turning `turn`
    # radians per keyframe, in a seeded plane.
    centre = normal(pd, 1, 3) * std
    phase = uniform(0.0, 2 * math.pi, pd, 1, 1)
    axis_a = normal(pd, 1, 3)
    axis_a = axis_a / torch.linalg.norm(axis_a, dim=-1, keepdim=True)
    axis_b = normal(pd, 1, 3)
    axis_b = axis_b - (axis_b * axis_a).sum(-1, keepdim=True) * axis_a
    axis_b = axis_b / torch.linalg.norm(axis_b, dim=-1, keepdim=True)
    ang = phase + cfg["turn"] * torch.arange(k, **f32).view(1, k, 1)
    p["motion_xyz"] = centre + cfg["orbit"] * (torch.cos(ang) * axis_a + torch.sin(ang) * axis_b)
    p["motion_f_dc"] = ((uniform(0.05, 0.95, pd, 1, 3)) - 0.5) / SH_C0
    p["motion_f_rest"] = normal(pd, n_rest, 3) * cfg["sh_std"]
    p["motion_scaling"] = uniform(lo_s, hi_s, pd, 3)
    p["motion_opacity"] = logit(uniform(op_lo, op_hi, pd, 1))
    # Visible over a seeded window of the duration, in keyframe units
    # u = (t + time_shift) / time_interval, fading over ~one interval.
    u0 = time_shift(cfg) / cfg["time_interval"]
    span = cfg["frames"] / cfg["time_interval"]
    length = uniform(0.25, 1.0, pd) * span
    start = u0 + uniform(0.0, 1.0, pd) * (span - length)
    p["motion_opacity_center"] = torch.stack([start, start + length], dim=-1)
    p["motion_opacity_var"] = uniform(-1.0, 0.5, pd, 2)
    base = quats(pd, 1)
    drift = normal(pd, k, 4) * cfg["rot_drift"]
    rot = base + torch.cumsum(drift, dim=1)
    p["motion_rotation"] = rot / torch.linalg.norm(rot, dim=-1, keepdim=True)

    if perturb:
        pg = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x5EED5EED)
        for key, sd in (("f_dc", perturb["color_std"]), ("motion_f_dc", perturb["color_std"]),
                        ("opacity", perturb["opacity_std"]),
                        ("motion_opacity", perturb["opacity_std"])):
            p[key] = p[key] + sd * torch.randn(p[key].shape, generator=pg, **f32)

    # Capacity padding: inactive rows hold the program's empty values.
    static_mask = torch.arange(ps, device=dev) < ns
    dynamic_mask = torch.arange(pd, device=dev) < nd
    for key, v in p.items():
        mask = dynamic_mask if key.startswith("motion_") else static_mask
        mb = mask.view(-1, *([1] * (v.ndim - 1)))
        p[key] = torch.where(mb, v, _empty_row(key, v))
    return {"params": p, "static_mask": static_mask, "dynamic_mask": dynamic_mask,
            "keyframe_num": k, "duration": float(cfg["frames"]), "active_sh_degree":
            cfg["sh_degree"]}


def _empty_row(key: str, v: torch.Tensor) -> torch.Tensor:
    """The value of an inactive capacity row (ex4dgs_tpu_torch's empty
    model: identity rotations, log-scale and logit -10, zeros)."""
    if key in ("opacity", "scaling", "motion_scaling", "motion_opacity"):
        return torch.full_like(v, -10.0)
    if key in ("rotation", "motion_rotation"):
        e = torch.zeros_like(v)
        e[..., 0] = 1.0
        return e
    return torch.zeros_like(v)


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------

class Program:
    """The port's model, configs and cameras for one configuration, built
    from the benchmark's inputs, and its entry points."""

    def __init__(self, cfg: dict, device):
        from ex4dgs_tpu_torch.kernel_config import KernelConfig
        from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig, overlay_json
        from ex4dgs_tpu_torch.rendering import default_capacity

        self.cfg, self.device = cfg, torch.device(device)
        self.mcfg = dataclasses.replace(overlay_json(ModelConfig(), cfg), duration=cfg["frames"])
        self.ocfg = overlay_json(OptimizationConfig(), cfg)
        self.kcfg = KernelConfig(tile_x=cfg["tile"][0], tile_y=cfg["tile"][1],
                                 exact_sort=cfg["exact_sort"]).validate()
        ps, pd = capacities(cfg)
        self.capacity = default_capacity(ps + pd, cfg["width"], cfg["height"], self.kcfg)

    def model(self, sc: dict):
        from ex4dgs_tpu_torch.models.state import empty_model

        ps, pd = capacities(self.cfg)
        m = empty_model(self.mcfg, ps, pd, sc["keyframe_num"], sc["duration"], self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        return m.replace(params=dict(sc["params"]), static_mask=sc["static_mask"],
                         dynamic_mask=sc["dynamic_mask"],
                         active_sh_degree=torch.tensor(sc["active_sh_degree"], **i32),
                         keyframe_num=torch.tensor(sc["keyframe_num"], **i32))

    def camera(self, c: dict):
        from ex4dgs_tpu_torch.rendering import RenderCamera

        return RenderCamera.from_fov(c["view"], c["proj"], c["campos"], c["width"],
                                     c["height"], c["fovx"], c["fovy"], device=self.device)

    def render(self, model, cam, t: float):
        """A frame as the trainer's viewer asks for it (Trainer._gui_render)."""
        from ex4dgs_tpu_torch.rendering import render

        with torch.no_grad():
            return render(cam, model, self.mcfg, t=t, bg=torch.zeros(3, device=self.device),
                          capacity=self.capacity, scaling_modifier=1.0, kernel_cfg=self.kcfg,
                          track_idx=False, device=self.device)

    def start(self, model) -> dict:
        """The training state the trainer carries from step to step: the
        model, fresh RAdam state, the step's statics."""
        from ex4dgs_tpu_torch.models.optimizer import init_state
        from ex4dgs_tpu_torch.train.step import StepStatics, train_step

        self._train_step = train_step
        state = init_state(model.params, device=self.device)
        statics = StepStatics(cfg=self.mcfg, opt=self.ocfg,
                              spatial_lr_scale=scene.cameras_extent(self.cfg),
                              capacity=self.capacity, kernel=self.kcfg)
        return {"model": model, "state": state, "statics": statics}

    def step(self, carried: dict, cams, gts, ts, bg, iteration: int):
        """One `train_step` on the one view; `carried` takes its state.
        (loss, binning total, NaN flag) as device tensors."""
        (cam,), (gt,), (t,) = cams, gts, ts
        out = self._train_step(carried["model"], carried["state"], cam, gt, t, bg, iteration,
                               carried["statics"], device=self.device)
        carried["model"], carried["state"] = out.model, out.opt_state
        return out.loss, out.binning_total, out.nan_flag

    @staticmethod
    def snapshot(carried: dict) -> dict:
        """The training state the reference compares, on the host."""
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

def census(cfg: dict, sc: dict, model, views) -> dict:
    """What one call of `model` over `views` [(host camera, t)] asks of the
    device, by the reference in float32, summed over the views:
    (contributing, applied) pairs, tile instances, visible static and
    dynamic splats, pixels; and the active parameter elements a step
    updates."""
    params = model.params
    masks = (sc["static_mask"], sc["dynamic_mask"])
    ps = masks[0].shape[0]
    out = {"pairs": (0, 0), "instances": 0, "static": 0, "dynamic": 0, "pixels": 0}
    with torch.no_grad():
        p = {k: v.float() for k, v in params.items()}
    for cam, t in views:
        with torch.no_grad():
            scr = R.project(*R.splats_at(p, masks, sc, cfg, t), cam, cfg)
            _, pairs, _ = R.composite(scr, cfg, cam, torch.zeros(3, device=scr.xy.device))
            order, _, _ = R.tile_lists(scr, cfg, cam["width"], cam["height"])
        out = {"pairs": (out["pairs"][0] + pairs[0], out["pairs"][1] + pairs[1]),
               "instances": out["instances"] + int(order.shape[0]),
               "static": out["static"] + int(scr.valid[:ps].sum()),
               "dynamic": out["dynamic"] + int(scr.valid[ps:].sum()),
               "pixels": out["pixels"] + cam["width"] * cam["height"]}
    rows = {"static": int(masks[0].sum()), "motion": int(masks[1].sum())}
    out["param_elements"] = sum(rows["motion" if k.startswith("motion_") else "static"]
                                * v[0].numel() for k, v in params.items())
    return out


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

BETA1 = R.BETA1
# The statistics that add up each step, and those that keep an extreme,
# with the difference beyond rounding: (tolerance, relative), absolute for
# whole pixels and frames, relative for an error.
SUMS = [n for what in ("grad", "count", "error", "ssim_error", "error_count")
        for n in R.STATS[what]]
EXTREMA = {n: (tol, what == "error_min") for what, tol in
           (("max_radius", 0.5), ("min_radius", 0.5), ("error_min_t", 0.5), ("error_min", 1e-2))
           for n in R.STATS[what]}


def _ref_scene(cfg: dict, seed: int, device, dtype, perturb=None):
    sc = make_params(cfg, seed, device, perturb=perturb)
    params = {k: v.to(dtype) for k, v in sc["params"].items()}
    return params, (sc["static_mask"], sc["dynamic_mask"]), sc


def _dhost(d: dict) -> dict:
    return {k: v.double().cpu() for k, v in d.items()}


def reference_stretch(cfg: dict, mix: dict, seed: int, device, x: dict,
                      start: dict | None = None, first: int = 0, dtype=torch.float64,
                      loss_rows=None, radam=R.radam) -> dict:
    """The reference's `checked_steps` steps computed in `dtype` from step
    `first` of the traffic: from the seeded scene with fresh optimizer
    state and statistics, or from `start` (params, mu, nu, step, stats on
    the host). With loss_rows, the loss is over those rows only; `radam`
    is the update (a fault's, in the control). Returns the losses, the
    first step's gradient, and the state at the start and after the steps
    (params, mu, nu, stats), on the host. The parameters are stored in
    float32 between steps, as the configuration holds them (in `dtype`
    where that is narrower): a step's change is about an ulp of them, so
    unrounded they would differ by the rounding alone."""
    from ..drive import backgrounds, entries

    p, masks, sc = _ref_scene(cfg, seed, device, dtype)
    if start is None:
        state, stats = R.init_state(p), R.init_stats(masks, dtype, device)
    else:
        def dev(d):
            return {k: v.to(device=device, dtype=dtype) for k, v in d.items()}

        p, stats = dev(start["params"]), dev(start["stats"])
        state = {"mu": dev(start["mu"]), "nu": dev(start["nu"]), "step": int(start["step"])}
    begin = {"params": _dhost(p), "mu": _dhost(state["mu"]), "nu": _dhost(state["nu"]),
             "stats": _dhost(stats)}
    gt_p, _, _ = _ref_scene(cfg, seed, device, dtype, perturb=mix["perturb"])
    bgs = backgrounds(seed, mix["backgrounds"], device).to(dtype)
    losses, grad1 = [], None
    for i in range(first, first + mix["checked_steps"]):
        (e,) = entries(x, i)
        cam, t = x["cams"][x["pool_cam"][e]], x["pool_t"][e]
        gt, _ = R.render(gt_p, masks, sc, cfg, cam, t, torch.zeros(3, dtype=dtype, device=device))
        step = R.StepInput(cam, t, gt, bgs[i % len(bgs)], mix["first_iteration"] + i)
        p, state, stats, loss, g = R.train_step(p, state, stats, masks, sc, cfg, step,
                                                x["spatial_scale"], loss_rows, radam)
        if torch.finfo(dtype).bits > 32:
            p = {k: v.float().to(dtype) for k, v in p.items()}
        losses.append(loss)
        if grad1 is None:
            grad1 = _dhost(g)
        del gt, g
    return {"losses": losses, "grad1": grad1, "begin": begin,
            "after": {"params": _dhost(p), "mu": _dhost(state["mu"]), "nu": _dhost(state["nu"]),
                      "stats": _dhost(stats)}}


def reference_frames(cfg: dict, seed: int, device, views, dtype=torch.float64):
    """The reference's frame [H, W, 3] of each (host camera, t) in `views`,
    one at a time."""
    p, masks, sc = _ref_scene(cfg, seed, device, dtype)
    zero = torch.zeros(3, dtype=dtype, device=device)
    for cam, t in views:
        yield R.render(p, masks, sc, cfg, cam, t, zero)[0]


# ---------------------------------------------------------------------------
# The control's faults: each the reference with the fault, in the
# program's place
# ---------------------------------------------------------------------------

def radam_nu_unfed(p, g, state, lrs):
    """RAdam whose stored second moment leaves out the new gradient's
    square (the update itself is RAdam's)."""
    new_p, new_state = R.radam(p, g, state, lrs)
    new_state["nu"] = {k: R.BETA2 * v for k, v in state["nu"].items()}
    return new_p, new_state


def faults(cfg: dict) -> dict:
    """{fault: reference_stretch keywords}: half of each image left out of
    the loss (the mean over the other half); the second moment stored
    without the new gradient's square."""
    return {"half_batch": {"loss_rows": slice(0, cfg["height"] // 2)},
            "nu_unfed": {"radam": radam_nu_unfed}}
