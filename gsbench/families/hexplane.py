"""4D-GS (Wu et al., CVPR 2024): canonical 3DGS Gaussians deformed at each
view's time by a HexPlane field and a small MLP, rendered by 3DGS's
rasterizer and trained on a batch of views a step with L1 plus the planes'
regularizers and Adam.

The family's parts of the benchmark (see `families/__init__.py`): its
scene in the program's parameter layout (`ex4dgs_tpu_torch.models.deform`),
the program's entry points (`rendering.render_deform`,
`train.step.train_step_deform`), the yardstick's census, the float64
reference (`gsbench/reference_hexplane.py`) over the training stretches and
the frames, and the control's faults. The traffic's times are frame
indices; the family maps frame f of `frames` to the source's normalised
time f / frames. The port is imported when a call needs it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import reference as R
from .. import reference_hexplane as HR
from .. import scene

VIEWS_PER_STEP = 4
SH_C0 = 0.28209479177387814
GAIN_ROWS = 4096  # rows the seeded MLP's output scale is measured on


# ---------------------------------------------------------------------------
# The scene
# ---------------------------------------------------------------------------

def capacity(cfg: dict) -> int:
    """Rows as the port holds them: n_gaussians rounded up to 4096."""
    return max(4096, -(-int(cfg["n_gaussians"]) // 4096) * 4096)


def normalised(cfg: dict, frame: float) -> float:
    """The source's time of frame index `frame`: frame / frames."""
    return float(frame) / cfg["frames"]


def make_params(cfg: dict, seed: int, device, perturb: dict | None = None) -> dict:
    """The scene's parameters, mask and field box (float32 on `device`)
    from `seed`, capacity-padded under the names of
    `ex4dgs_tpu_torch.models.deform`, drawn from one `torch.Generator` in a
    few large calls.

    The Gaussians: a cloud of std `cloud_std` about the origin,
    log-uniform sizes in `splat_size`, random orientations, colours (DC)
    uniform in [0.05, 0.95], the other SH rows N(0, `sh_std`), opacities
    uniform in `opacity`; the box is the active cloud's. The field: spatial
    planes uniform in [0.1, 0.5] and time planes one (the source's
    initialisation) plus N(0, `time_plane_std`), so that the deformation
    varies with t; the MLP's weights Xavier-uniform, its biases zero, and
    every head's last layer scaled by one factor that makes the RMS of
    |Dx| `deform_rms` x `cloud_std` over the first GAIN_ROWS Gaussians at t
    = 0.5 (measured on the host in float64, so every device draws the same
    factor from the same weights). `perturb` (colour and opacity standard
    deviations) adds seeded noise to colours and opacities only, from a
    second stream of the same seed: the target the training cell fits."""
    dev = torch.device(device)
    P, n = capacity(cfg), cfg["n_gaussians"]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, **f32)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    lo_s, hi_s = (math.log(v) for v in cfg["splat_size"])
    op_lo, op_hi = cfg["opacity"]
    p = {}
    p["xyz"] = normal(P, 3) * cfg["cloud_std"]
    p["scaling"] = uniform(lo_s, hi_s, P, 3)
    q = normal(P, 4)
    p["rotation"] = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    p["opacity"] = torch.logit(uniform(op_lo, op_hi, P, 1))
    p["f_dc"] = (uniform(0.05, 0.95, P, 1, 3) - 0.5) / SH_C0
    p["f_rest"] = normal(P, (cfg["sh_degree"] + 1) ** 2 - 1, 3) * cfg["sh_std"]
    if perturb:
        pg = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x5EED5EED)
        for key, sd in (("f_dc", perturb["color_std"]), ("opacity", perturb["opacity_std"])):
            p[key] = p[key] + sd * torch.randn(p[key].shape, generator=pg, **f32)
    mask = torch.arange(P, device=dev) < n
    for key, v in p.items():
        p[key] = torch.where(mask.view(-1, *([1] * (v.ndim - 1))), v, _empty_row(key, v))
    aabb = torch.stack([p["xyz"][:n].amin(0), p["xyz"][:n].amax(0)])
    for key, shape in HR.field_shapes(cfg).items():
        if key.startswith("grid."):
            if int(key.split(".")[2]) in HR.TIME:
                p[key] = 1.0 + cfg["time_plane_std"] * normal(*shape)
            else:
                p[key] = uniform(0.1, 0.5, *shape)
        elif key.endswith(".weight"):
            bound = math.sqrt(6.0 / (shape[0] + shape[1]))
            p[key] = uniform(-bound, bound, *shape)
        else:
            p[key] = torch.zeros(shape, **f32)
    gain = _gain(cfg, p, aabb, n)
    for head, _ in HR.HEADS:
        p[f"{head}.3.weight"] = p[f"{head}.3.weight"] * gain
    return {"params": p, "mask": mask, "aabb": aabb}


def _gain(cfg: dict, p: dict, aabb, n: int) -> float:
    """The factor that takes the RMS of |Dx| over the first GAIN_ROWS rows
    at t = 0.5 to deform_rms x cloud_std, in float64 on the host, rounded
    to 6 significant digits."""
    rows = min(n, GAIN_ROWS)
    q = {k: (v[:rows] if k in HR.ROWS else v).double().cpu() for k, v in p.items()}
    with torch.no_grad():
        xyz = q["xyz"]
        lo, hi = aabb[0].double().cpu(), aabb[1].double().cpu()
        c = (xyz - lo) * (2.0 / (hi - lo)) - 1.0
        coords = torch.cat([c, torch.full_like(c[:, :1], 0.5)], -1)
        dx = HR.mlp(q, HR.field(q, coords))[0]
    rms = float(torch.sqrt((dx * dx).sum(-1).mean()))
    return float(f"{cfg['deform_rms'] * cfg['cloud_std'] / rms:.6g}")


def _empty_row(key: str, v: torch.Tensor) -> torch.Tensor:
    """The value of an inactive row (deform's empty model: identity
    quaternion, log-scales and logit -10, zeros)."""
    if key in ("scaling", "opacity"):
        return torch.full_like(v, -10.0)
    if key == "rotation":
        e = torch.zeros_like(v)
        e[..., 0] = 1.0
        return e
    return torch.zeros_like(v)


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------

class Program:
    """The port's 4D-GS model, configs and cameras for one configuration,
    and its entry points."""

    def __init__(self, cfg: dict, device):
        from ex4dgs_tpu_torch.kernel_config import KernelConfig
        from ex4dgs_tpu_torch.models.config import (ModelDeformConfig, OptimizationDeformConfig,
                                                    overlay_json)
        from ex4dgs_tpu_torch.rendering import default_capacity

        self.cfg, self.device = cfg, torch.device(device)
        planes = cfg["kplanes_config"]
        self.mcfg = dataclasses.replace(
            overlay_json(ModelDeformConfig(), cfg), multires=tuple(cfg["multires"]),
            resolution=tuple(planes["resolution"]),
            output_coordinate_dim=planes["output_coordinate_dim"])
        self.ocfg = overlay_json(OptimizationDeformConfig(), cfg)
        self.kcfg = KernelConfig(tile_x=cfg["tile"][0], tile_y=cfg["tile"][1],
                                 exact_sort=cfg["exact_sort"]).validate()
        self.capacity = default_capacity(capacity(cfg), cfg["width"], cfg["height"], self.kcfg)

    def model(self, sc: dict):
        from ex4dgs_tpu_torch.models.deform import DeformModel
        from ex4dgs_tpu_torch.models.state4d import empty_stats

        return DeformModel(params=dict(sc["params"]), mask=sc["mask"],
                           stats=empty_stats(sc["mask"].shape[0], self.device), aabb=sc["aabb"])

    def camera(self, c: dict):
        from ex4dgs_tpu_torch.rendering import RenderCamera

        return RenderCamera.from_fov(c["view"], c["proj"], c["campos"], c["width"],
                                     c["height"], c["fovx"], c["fovy"], device=self.device)

    def render(self, model, cam, t: float):
        """The frame of frame index t, with no gradient."""
        from ex4dgs_tpu_torch.rendering import render_deform

        with torch.no_grad():
            return render_deform(cam, model, self.mcfg, t=normalised(self.cfg, t),
                                 bg=torch.zeros(3, device=self.device), capacity=self.capacity,
                                 kernel_cfg=self.kcfg, device=self.device)

    def start(self, model) -> dict:
        """The training state carried from step to step: the model, fresh
        Adam state, the step's statics."""
        from ex4dgs_tpu_torch.models.optimizer import init_state
        from ex4dgs_tpu_torch.train.step import Step4DStatics, train_step_deform

        self._train_step = train_step_deform
        statics = Step4DStatics(cfg=self.mcfg, opt=self.ocfg,
                                spatial_lr_scale=scene.cameras_extent(self.cfg),
                                capacity=self.capacity, kernel=self.kcfg)
        return {"model": model, "state": init_state(model.params, device=self.device),
                "statics": statics}

    def step(self, carried: dict, cams, gts, ts, bg, iteration: int):
        """One `train_step_deform` on the views; `carried` takes its state.
        (loss, the largest view's binning total, NaN flag) as device
        tensors."""
        out = self._train_step(carried["model"], carried["state"], cams, gts,
                               [normalised(self.cfg, t) for t in ts], bg, iteration,
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

def census(cfg: dict, sc: dict, model, views) -> dict:
    """What one call of `model` over `views` [(host camera, frame)] asks of
    the device, by the reference in float32, summed over the views:
    (contributing, applied) pairs, tile instances, visible Gaussians,
    pixels, the active Gaussians the field deforms (`deformed`, one per
    Gaussian and view), the views; and the planes' elements (each view's
    field reads them, the regularizers once) and the active parameter
    elements a step updates."""
    mask = sc["mask"]
    active = int(mask.sum())
    out = {"pairs": (0, 0), "instances": 0, "visible": 0, "pixels": 0, "deformed": 0}
    with torch.no_grad():
        p = {k: v.float() for k, v in model.params.items()}
        for cam, frame in views:
            scr = HR.screen(p, mask, sc["aabb"], cfg, cam, normalised(cfg, frame))
            _, pairs, _ = R.composite(scr, cfg, cam, torch.zeros(3, device=scr.xy.device))
            order, _, _ = R.tile_lists(scr, cfg, cam["width"], cam["height"])
            out = {"pairs": (out["pairs"][0] + pairs[0], out["pairs"][1] + pairs[1]),
                   "instances": out["instances"] + int(order.shape[0]),
                   "visible": out["visible"] + int(scr.valid.sum()),
                   "pixels": out["pixels"] + cam["width"] * cam["height"],
                   "deformed": out["deformed"] + active}
    out["views"] = len(views)
    out["plane_elements"] = sum(v.numel() for k, v in model.params.items()
                                if k.startswith("grid."))
    out["param_elements"] = sum(v[0].numel() * active if k in HR.ROWS else v.numel()
                                for k, v in model.params.items())
    return out


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

BETA1 = HR.BETA1
SUMS = ["xyz_gradient_accum", "denom"]
# whole pixels: a radius differs beyond rounding by half a pixel
EXTREMA = {"max_radii2D": (0.5, False)}


def _ref_scene(cfg: dict, seed: int, device, dtype, perturb=None):
    sc = make_params(cfg, seed, device, perturb=perturb)
    return {k: v.to(dtype) for k, v in sc["params"].items()}, sc["mask"], sc["aabb"]


def _dhost(d: dict) -> dict:
    return {k: v.double().cpu() for k, v in d.items()}


def reference_stretch(cfg: dict, mix: dict, seed: int, device, x: dict,
                      start: dict | None = None, first: int = 0, dtype=torch.float64,
                      **fault) -> dict:
    """The reference's `checked_steps` steps of VIEWS_PER_STEP views
    computed in `dtype` from step `first` of the traffic: from the seeded
    scene with fresh Adam state and statistics, or from `start` (params,
    mu, nu, step, stats on the host). fault takes the control's faults
    (`faults`). Returns the losses, the first step's gradient, and the
    state at the start and after the steps, on the host; the parameters
    are stored in float32 between steps, as the program holds them."""
    from ..drive import backgrounds, entries

    p, mask, aabb = _ref_scene(cfg, seed, device, dtype)
    if start is None:
        state, stats = HR.init_state(p), HR.init_stats(mask, dtype, device)
    else:
        def dev(d):
            return {k: v.to(device=device, dtype=dtype) for k, v in d.items()}

        p, stats = dev(start["params"]), dev(start["stats"])
        state = {"mu": dev(start["mu"]), "nu": dev(start["nu"]), "step": int(start["step"])}
    begin = {"params": _dhost(p), "mu": _dhost(state["mu"]), "nu": _dhost(state["nu"]),
             "stats": _dhost(stats)}
    gt_p, _, _ = _ref_scene(cfg, seed, device, dtype, perturb=mix["perturb"])
    bgs = backgrounds(seed, mix["backgrounds"], device).to(dtype)
    zero = torch.zeros(3, dtype=dtype, device=device)
    losses, grad1 = [], None
    for i in range(first, first + mix["checked_steps"]):
        views = []
        for e in entries(x, i):
            cam, t = x["cams"][x["pool_cam"][e]], normalised(cfg, x["pool_t"][e])
            views.append(HR.View(cam, t, HR.render(gt_p, mask, aabb, cfg, cam, t, zero)[0]))
        out = HR.train_step(p, state, stats, mask, aabb, cfg, views, bgs[i % len(bgs)],
                            mix["first_iteration"] + i, x["spatial_scale"], **fault)
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
    p, mask, aabb = _ref_scene(cfg, seed, device, dtype)
    zero = torch.zeros(3, dtype=dtype, device=device)
    for cam, frame in views:
        yield HR.render(p, mask, aabb, cfg, cam, normalised(cfg, frame), zero)[0]


# ---------------------------------------------------------------------------
# The control's faults: each the reference with the fault, in the
# program's place
# ---------------------------------------------------------------------------

def faults(cfg: dict) -> dict:
    """{fault: reference_stretch keywords}: the MLP's products in TF32;
    the second scale's features zeroed; the time planes not trained; no SH
    offset; no regularizer."""
    return {"mlp_tf32": {"mlp_tf32": True}, "scale2_off": {"scale2_off": True},
            "time_planes_frozen": {"time_planes_frozen": True}, "dsh_off": {"dsh_off": True},
            "reg_off": {"reg_off": True}}
