"""4D-GS's model state and deformation (Wu et al., CVPR 2024): canonical
3DGS Gaussians, capacity-padded, and a deformation field that moves them to
time t.

The rows (ROW_KEYS, the source's names) are 3DGS's: mean `xyz`, `f_dc` and
`f_rest` (16 SH rows at degree 3), log-scales `scaling`, quaternion
`rotation`, opacity logit `opacity`; rows past the active ones hold
`empty_params`' values and are left out by `mask`. The field's parameters
are not rows: the HexPlane's planes (`grid.<scale>.<plane>`, each [C, R_b,
R_a], `ops/hexplane.py`) and the MLP's linear layers under the source's
module names (`feature_out.0`, then the five heads `<head>.1` and
`<head>.3`, weights [out, in] and biases). `aabb` [2, 3] is the box the
field normalises positions to, fixed when the model is made. The
statistics are 4D Gaussian Splatting's three (`state4d.STAT_KEYS`).

The deformation at time t (`deform`):
  c      = (2 (x - aabb_min) / (aabb_max - aabb_min) - 1, t)
  f      = HexPlane(c)                                 [P, C x scales]
  h      = W_0 f + b_0                                 (defor_depth 0: no activation)
  Delta  = W_2 relu(W_1 relu(h) + b_1) + b_2           per head
  x' = x + Dx, s' = s + Ds, q' = q + Dr, o' = o + Do, SH' = SH + Dsh,
each before its activation (`rendering.render_deform` applies them).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .. import scalar_on
from ..ops.hexplane import PAIRS, hexplane, plane_keys
from ..runtime.profiling import span
from .config import ModelDeformConfig
from .state4d import STAT_KEYS

ROW_KEYS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
# The heads in the source's order and their widths: position, scales,
# rotations, opacity and SH (16 rows of 3).
HEADS = (("pos_deform", 3), ("scales_deform", 3), ("rotations_deform", 4),
         ("opacity_deform", 1), ("shs_deform", 48))


@dataclasses.dataclass
class DeformModel:
    """All of 4D-GS's model state on one device."""

    params: dict  # ROW_KEYS [P, ...] and the field's (field_shapes) float32
    mask: torch.Tensor  # [P] bool, active Gaussians
    stats: dict  # name -> [P] float32, state4d.STAT_KEYS
    aabb: torch.Tensor  # [2, 3] the field's box (min, max)

    @property
    def capacity(self) -> int:
        return self.params["xyz"].shape[0]

    @property
    def device(self) -> torch.device:
        return self.params["xyz"].device

    def replace(self, **changes) -> "DeformModel":
        return dataclasses.replace(self, **changes)


def row_shapes(capacity: int, sh_degree: int = 3) -> dict:
    n_rest = (sh_degree + 1) ** 2 - 1
    return {"xyz": (capacity, 3), "f_dc": (capacity, 1, 3), "f_rest": (capacity, n_rest, 3),
            "scaling": (capacity, 3), "rotation": (capacity, 4), "opacity": (capacity, 1)}


def field_shapes(cfg: ModelDeformConfig) -> dict:
    """name -> shape of every field parameter: the planes (scale-major; at
    scale m the spatial resolutions times m, the time one as it is), then
    the MLP's layers."""
    out = {}
    C = cfg.output_coordinate_dim
    for s, m in enumerate(cfg.multires):
        res = [r * m for r in cfg.resolution[:3]] + list(cfg.resolution[3:])
        for k, (a, b) in enumerate(PAIRS):
            out[f"grid.{s}.{k}"] = (C, res[b], res[a])
    W = cfg.net_width
    width_in = C * len(cfg.multires)
    for i in range(cfg.defor_depth + 1):
        out[f"feature_out.{2 * i}.weight"] = (W, width_in if i == 0 else W)
        out[f"feature_out.{2 * i}.bias"] = (W,)
    for head, k in HEADS:
        out.update({f"{head}.1.weight": (W, W), f"{head}.1.bias": (W,),
                    f"{head}.3.weight": (k, W), f"{head}.3.bias": (k,)})
    return out


def time_plane(k: int) -> bool:
    """Whether plane k of a scale holds t."""
    return 3 in PAIRS[k]


def empty_params(capacity: int, cfg: ModelDeformConfig, device) -> dict:
    """Inactive rows (zero means and features, identity quaternions,
    log-scales and opacity logit -10) and the field at the source's
    initial values: spatial planes 0.3 (the middle of their uniform draw),
    time planes one, the MLP zero."""
    f32 = dict(dtype=torch.float32, device=device)
    out = {}
    for k, shape in row_shapes(capacity, cfg.sh_degree).items():
        if k in ("scaling", "opacity"):
            out[k] = torch.full(shape, -10.0, **f32)
        elif k == "rotation":
            out[k] = torch.zeros(shape, **f32)
            out[k][:, 0] = 1.0
        else:
            out[k] = torch.zeros(shape, **f32)
    for k, shape in field_shapes(cfg).items():
        if k.startswith("grid."):
            out[k] = torch.full(shape, 1.0 if time_plane(int(k.split(".")[2])) else 0.3, **f32)
        else:
            out[k] = torch.zeros(shape, **f32)
    return out


def empty_model(cfg: ModelDeformConfig, capacity: int, device=None) -> DeformModel:
    """A model of `capacity` rows (rounded up to the port's granularity),
    none active, its field's box the unit cube about the origin."""
    from .. import resolve_device
    from .state import round_capacity

    dev = resolve_device(device)
    cap = round_capacity(capacity)
    return DeformModel(params=empty_params(cap, cfg, dev),
                       mask=torch.zeros(cap, dtype=torch.bool, device=dev),
                       stats={k: torch.zeros(cap, dtype=torch.float32, device=dev)
                              for k in STAT_KEYS},
                       aabb=torch.tensor([[-1.0] * 3, [1.0] * 3], device=dev))


def deform(params: dict, aabb, t, cfg: ModelDeformConfig):
    """(x', s', q', o', SH' [P, 16, 3]) of the rows of `params` at time t (a
    number or a 0-d tensor on their device): the field and the MLP (see the
    module docstring), before the activations."""
    with span("ex4dgs.deform"):
        xyz = params["xyz"]
        P = xyz.shape[0]
        c = (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0
        tc = scalar_on(t, xyz.device).reshape(1, 1).expand(P, 1)
        coords = torch.cat([c, tc], -1)
        with span("ex4dgs.hexplane"):
            f = hexplane(coords, [params[k] for k in plane_keys(len(cfg.multires))])
        with span("ex4dgs.deform_mlp"):
            h = f
            for i in range(cfg.defor_depth + 1):
                if i:
                    h = F.relu(h)
                h = F.linear(h, params[f"feature_out.{2 * i}.weight"],
                             params[f"feature_out.{2 * i}.bias"])
            hr = F.relu(h)
            deltas = []
            for head, _ in HEADS:
                z = F.relu(F.linear(hr, params[f"{head}.1.weight"], params[f"{head}.1.bias"]))
                deltas.append(F.linear(z, params[f"{head}.3.weight"], params[f"{head}.3.bias"]))
        dx, ds, dr, do, dsh = deltas
        sh = torch.cat([params["f_dc"], params["f_rest"]], 1)
        return (xyz + dx, params["scaling"] + ds, params["rotation"] + dr,
                params["opacity"] + do, sh + dsh.view(P, -1, 3))
