"""Adaptive density control: clone / split / prune / extract / expand.

Counterpart of `ex4dgs_tpu/models/density.py`. The events fire every few
hundred iterations, so they run on the host in numpy on compacted arrays
(active rows only) and the model is re-padded to bucketed capacities
afterwards; the RAdam state surgery is row masking and concatenation on the
`mu`/`nu` arrays. The events are the JAX package's numpy code, line for
line, and draw from the numpy Generator in the same order, so the same
HostModel and Generator state give the JAX package's arrays exactly.

`pull` moves a device model and its optimizer state to a HostModel
(through `model_to_numpy`), `push` moves one back onto a device (through
`model_from_numpy`), keeping the capacity-padded layout.

Semantics notes (kept from the reference):
  * clone copies xyz_error_min/timestamp for the clones; split resets them
    for the new halves;
  * every densification resets gradient/error accumulators and radii for ALL
    points but preserves error_min pairs;
  * the reference's training loop always passes size_threshold=None, so the
    big-point branches of split/prune are gated by arguments here too;
  * the reference's prune_invisible computes a duration-collapse condition
    and discards it; only the used condition is kept.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .config import ModelConfig, OptimizationConfig
from .optimizer import RAdamState
from .state import (
    KEYFRAME_KEYS,
    STATIC_KEYS,
    STATIC_STAT_KEYS,
    GaussianModel,
    _empty_dynamic,
    _empty_static,
    _init_stats,
    model_from_numpy,
    model_to_numpy,
    round_capacity,
)

_HOST = torch.device("cpu")


@dataclasses.dataclass
class HostModel:
    """Compact (active rows only) numpy mirror of model + optimizer state."""

    params: dict  # name -> np.ndarray, active rows
    stats: dict  # name -> np.ndarray [n]
    mu: dict
    nu: dict
    step: int
    active_sh_degree: int
    duration: float
    keyframe_num: int

    @property
    def n_static(self) -> int:
        return self.params["xyz"].shape[0]

    @property
    def n_dynamic(self) -> int:
        return self.params["motion_xyz"].shape[0]


def pull(model: GaussianModel, opt_state: RAdamState) -> HostModel:
    """The active rows (and active keyframes) of a device model and its
    optimizer state, as numpy."""
    arrays = model_to_numpy(model)
    sm, dm = arrays["static_mask"], arrays["dynamic_mask"]
    kn = int(arrays["keyframe_num"])

    def sel(k, v):
        out = v[dm if k.startswith("motion_") else sm]
        # Active keyframes only: the reference's arrays are exactly
        # keyframe_num wide; the padded capacity is a device-side detail.
        if k in KEYFRAME_KEYS:
            out = out[:, :kn]
        return out

    def host(v):
        return v.detach().cpu().numpy()

    return HostModel(
        params={k: sel(k, v) for k, v in arrays["params"].items()},
        stats={k: v[dm if k.startswith("motion_") else sm] for k, v in arrays["stats"].items()},
        mu={k: sel(k, host(v)) for k, v in opt_state.mu.items()},
        nu={k: sel(k, host(v)) for k, v in opt_state.nu.items()},
        step=int(opt_state.step),
        active_sh_degree=int(arrays["active_sh_degree"]),
        duration=float(arrays["duration"]),
        keyframe_num=kn,
    )


def push(hm: HostModel, cfg: ModelConfig, static_capacity: int | None = None,
         dynamic_capacity: int | None = None, keyframe_capacity: int | None = None,
         device=None) -> tuple[GaussianModel, RAdamState]:
    """A HostModel re-padded to the given capacities (bucketed from its row
    counts where not given) as a model and optimizer state on `device`
    (cuda unless told otherwise). Padding rows and keyframes hold the empty
    model's values and zero moments."""
    ns, nd = hm.n_static, hm.n_dynamic
    sc = static_capacity or round_capacity(ns)
    dc = dynamic_capacity if dynamic_capacity is not None else (
        round_capacity(nd, 1024) if nd > 0 else 0
    )
    kc = keyframe_capacity or max(hm.keyframe_num, hm.params["motion_xyz"].shape[1])

    tangents = cfg.interp_type == "cubic_diff" or "motion_xyz_d" in hm.params
    base = _empty_static(sc, cfg.sh_degree, _HOST)
    base.update(_empty_dynamic(dc, kc, cfg.sh_degree, _HOST, tangents=tangents))
    params, mu, nu = {}, {}, {}
    for k, empty in base.items():
        n = nd if k.startswith("motion_") else ns
        arr = empty.numpy()  # a fresh array of the empty model's values
        v = hm.params.get(k)  # absent => stays empty (e.g. tangents added now)
        if v is not None:
            if k in KEYFRAME_KEYS:
                # always via the keyframe path: kc may exceed v's K axis
                # (pre-allocated keyframe capacity), including when n == 0
                kf = min(v.shape[1], kc)
                arr[:n, :kf] = v[:n, :kf]
            else:
                arr[:n] = v
        params[k] = arr
        for src, dst in ((hm.mu, mu), (hm.nu, nu)):
            a = np.zeros_like(arr)
            w = src.get(k)
            if w is not None:
                if k in KEYFRAME_KEYS:
                    kf = min(w.shape[1], kc)
                    a[:n, :kf] = w[:n, :kf]
                else:
                    a[:n] = w
            dst[k] = a

    stats = {k: v.numpy() for k, v in _init_stats(sc, dc, _HOST).items()}
    for k, v in hm.stats.items():
        n = nd if k.startswith("motion_") else ns
        stats[k][:n] = v

    model = model_from_numpy(
        params=params,
        static_mask=np.arange(sc) < ns,
        dynamic_mask=np.arange(dc) < nd,
        stats=stats,
        active_sh_degree=np.asarray(hm.active_sh_degree, np.int32),
        duration=np.asarray(hm.duration, np.float32),
        keyframe_num=np.asarray(hm.keyframe_num, np.int32),
        device=device,
    )
    dev = model.device
    opt_state = RAdamState(mu={k: torch.as_tensor(v, device=dev) for k, v in mu.items()},
                           nu={k: torch.as_tensor(v, device=dev) for k, v in nu.items()},
                           step=torch.tensor(hm.step, dtype=torch.int32, device=dev))
    return model, opt_state


# ---------------------------------------------------------------------------
# Row surgery primitives
# ---------------------------------------------------------------------------

def _prune_rows(hm: HostModel, static_drop: np.ndarray, dynamic_drop: np.ndarray):
    """Drop rows where mask is True (reference prune_points, :715-763)."""
    keep_s = ~static_drop
    keep_d = ~dynamic_drop if dynamic_drop.size else np.zeros((0,), bool)
    for k in hm.params:
        keep = keep_d if k.startswith("motion_") else keep_s
        hm.params[k] = hm.params[k][keep]
        hm.mu[k] = hm.mu[k][keep]
        hm.nu[k] = hm.nu[k][keep]
    for k in hm.stats:
        keep = keep_d if k.startswith("motion_") else keep_s
        hm.stats[k] = hm.stats[k][keep]


def _cat_rows(hm: HostModel, new_static: dict | None, new_dynamic: dict | None,
              keep_stats: dict | None = None):
    """Append rows; optimizer moments zero-filled for the new rows
    (cat_tensors_to_optimizer, :765-787). Afterwards, gradient/error accums
    and radii stats are RESET for all rows (densification_postfix, :830-844)
    except keys listed in keep_stats (already-updated error_min pairs)."""
    keep_stats = keep_stats or {}
    n_new_s = n_new_d = 0
    for k in hm.params:
        src = None
        if new_static and k in new_static:
            src = new_static[k]
        if new_dynamic and k in new_dynamic:
            src = new_dynamic[k]
        if src is None:
            continue
        if k.startswith("motion_"):
            n_new_d = src.shape[0]
        else:
            n_new_s = src.shape[0]
        hm.params[k] = np.concatenate([hm.params[k], src], axis=0)
        hm.mu[k] = np.concatenate([hm.mu[k], np.zeros_like(src)], axis=0)
        hm.nu[k] = np.concatenate([hm.nu[k], np.zeros_like(src)], axis=0)

    ns, nd = hm.n_static, hm.n_dynamic
    for k in list(hm.stats):
        if k in keep_stats:
            hm.stats[k] = keep_stats[k]
            continue
        n = nd if k.startswith("motion_") else ns
        if "min_radii" in k or ("error_min" in k and "timestamp" not in k):
            hm.stats[k] = np.full((n,), 1000.0, np.float32)
        elif "timestamp" in k:
            hm.stats[k] = np.full((n,), -1.0, np.float32)
        else:
            hm.stats[k] = np.zeros((n,), np.float32)
    return n_new_s, n_new_d


def _replace_param(hm: HostModel, updates: dict):
    """Replace a parameter value, zeroing its moments
    (replace_tensor_to_optimizer, :672-691)."""
    for k, v in updates.items():
        hm.params[k] = v.astype(hm.params[k].dtype, copy=False)
        hm.mu[k] = np.zeros_like(v, dtype=np.float32)
        hm.nu[k] = np.zeros_like(v, dtype=np.float32)


def _build_rotation(q: np.ndarray) -> np.ndarray:
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        np.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        np.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)
    return R


# ---------------------------------------------------------------------------
# Density-control events
# ---------------------------------------------------------------------------

def densify_and_prune(
    hm: HostModel,
    cfg: ModelConfig,
    opt: OptimizationConfig,
    extent: float,
    rng: np.random.Generator,
    *,
    max_screen_size: float | None = None,
    max_dynamic_screen_size: float | None = None,
    min_opacity: float = 0.01,
    min_motion_opacity: float = 0.01,
    s_max_ssim: float = 0.0,
    s_l1_thres: float = 100.0,
    d_max_ssim: float = 0.0,
    d_l1_thres: float = 100.0,
) -> None:
    """clone + split + prune (c_gaussian_model.py:1019-1072)."""
    interval = cfg.time_interval
    time_shift = cfg.time_shift

    with np.errstate(divide="ignore", invalid="ignore"):
        s_grads = np.nan_to_num(hm.stats["xyz_gradient_accum"] / hm.stats["denom"])
        d_grads = np.nan_to_num(
            hm.stats["motion_xyz_gradient_accum"] / hm.stats["motion_denom"]
        ) if hm.n_dynamic else np.zeros((0,), np.float32)

    s_scale = np.exp(hm.params["scaling"]).max(axis=1)
    d_scale = np.exp(hm.params["motion_scaling"]).max(axis=1) if hm.n_dynamic else None
    pd_ext = opt.percent_dense * extent
    ns0, nd0 = hm.n_static, hm.n_dynamic

    # ---- clone (densify_and_clone, :966-1017)
    cs = (np.abs(s_grads) >= opt.densify_grad_threshold) & (s_scale <= pd_ext)
    new_s = {k: hm.params[k][cs].copy() for k in STATIC_KEYS}
    keep = {
        "xyz_error_min": np.concatenate(
            [hm.stats["xyz_error_min"], hm.stats["xyz_error_min"][cs]]
        ),
        "xyz_error_min_timestamp": np.concatenate(
            [hm.stats["xyz_error_min_timestamp"], hm.stats["xyz_error_min_timestamp"][cs]]
        ),
    }
    new_d = None
    if hm.n_dynamic:
        cd = (np.abs(d_grads) >= opt.densify_dgrad_threshold) & (d_scale <= pd_ext)
        new_d = {k: hm.params[k][cd].copy() for k in hm.params
                 if k.startswith("motion_")}
        c = new_d["motion_opacity_center"]
        ln = np.maximum(np.abs(c[:, 1] - c[:, 0]) / 3.0, 2.0 / interval)
        c[:, 1] = c[:, 1] + ln * rng.standard_normal(c.shape[0]).astype(np.float32)
        c[:, 0] = c[:, 0] + ln * rng.standard_normal(c.shape[0]).astype(np.float32)
        np.clip(c, (time_shift + 1) / interval,
                (time_shift + hm.duration - 1) / interval, out=c)
        new_d["motion_opacity_var"] = np.full_like(new_d["motion_opacity_var"], 2.0)
        keep["motion_xyz_error_min"] = np.concatenate(
            [hm.stats["motion_xyz_error_min"], hm.stats["motion_xyz_error_min"][cd]]
        )
        keep["motion_xyz_error_min_timestamp"] = np.concatenate(
            [hm.stats["motion_xyz_error_min_timestamp"],
             hm.stats["motion_xyz_error_min_timestamp"][cd]]
        )
    _cat_rows(hm, new_s, new_d, keep_stats=keep)

    # ---- split (densify_and_split, :874-964): grads zero-padded to the
    # post-clone count, so clones never split in the same event.
    N = 2
    pad_s = np.zeros(hm.n_static, np.float32)
    pad_s[:ns0] = s_grads
    s_scale2 = np.exp(hm.params["scaling"]).max(axis=1)
    ss = (pad_s >= opt.densify_grad_threshold) & (s_scale2 > pd_ext)
    if max_screen_size:
        ss |= hm.stats["max_radii2D"] > max_screen_size
        ss |= s_scale2 > 0.1 * extent
    stds = np.repeat(np.exp(hm.params["scaling"][ss]), N, axis=0)
    samples = (rng.standard_normal(stds.shape) * stds).astype(np.float32)
    rots = np.repeat(_build_rotation(hm.params["rotation"][ss]), N, axis=0)
    new_s = {
        "xyz": np.einsum("nij,nj->ni", rots, samples)
        + np.repeat(hm.params["xyz"][ss], N, axis=0),
        # log-domain form of log(exp(s)/(0.8N)) (c_gaussian_model.py:905):
        # exp(s) underflows to 0 for collapsed splats (s < ~-87 in f32),
        # poisoning the new row with -inf
        "scaling": np.repeat(hm.params["scaling"][ss], N, axis=0)
        - np.float32(np.log(0.8 * N)),
    }
    for k in ("rotation", "f_dc", "f_rest", "opacity", "xyz_disp"):
        new_s[k] = np.repeat(hm.params[k][ss], N, axis=0)
    n_split_s = int(ss.sum())
    keep = {
        "xyz_error_min": np.concatenate(
            [hm.stats["xyz_error_min"], np.full((n_split_s * N,), 1000.0, np.float32)]
        ),
        "xyz_error_min_timestamp": np.concatenate(
            [hm.stats["xyz_error_min_timestamp"], np.full((n_split_s * N,), -1.0, np.float32)]
        ),
    }
    new_d = None
    sd = np.zeros((hm.n_dynamic,), bool)
    if hm.n_dynamic:
        pad_d = np.zeros(hm.n_dynamic, np.float32)
        pad_d[:nd0] = d_grads
        d_scale2 = np.exp(hm.params["motion_scaling"]).max(axis=1)
        sd = (pad_d >= opt.densify_dgrad_threshold) & (d_scale2 > pd_ext)
        if max_dynamic_screen_size:
            sd |= hm.stats["motion_max_radii2D"] > max_dynamic_screen_size
            sd |= d_scale2 > 0.1 * extent
        kf = hm.params["motion_xyz"].shape[1]
        stds = np.repeat(np.exp(hm.params["motion_scaling"][sd]), N, axis=0) * 2
        samples = (rng.standard_normal(stds.shape) * stds).astype(np.float32)
        samples = np.repeat(samples[:, None, :], kf, axis=1).reshape(-1, 3)
        rots_m = _build_rotation(hm.params["motion_rotation"][sd].reshape(-1, 4))
        rots_m = np.tile(rots_m.reshape(-1, kf, 3, 3), (N, 1, 1, 1)).reshape(-1, 3, 3)
        disp = np.einsum("nij,nj->ni", rots_m, samples).reshape(-1, kf, 3)
        new_d = {
            "motion_xyz": disp + np.repeat(hm.params["motion_xyz"][sd], N, axis=0),
            # log-domain (see the static split above): avoids exp underflow
            "motion_scaling": np.repeat(hm.params["motion_scaling"][sd], N, axis=0)
            - np.float32(np.log(0.8 * N)),
        }
        for k in hm.params:
            if k.startswith("motion_") and k not in (
                "motion_xyz", "motion_scaling",
                "motion_opacity_center", "motion_opacity_var",
            ):
                new_d[k] = np.repeat(hm.params[k][sd], N, axis=0)
        c = np.repeat(hm.params["motion_opacity_center"][sd], N, axis=0).copy()
        ln = np.maximum(np.abs(c[:, 1] - c[:, 0]) / 3.0, 2.0 / interval)
        c[:, 1] = c[:, 1] + ln * rng.standard_normal(c.shape[0]).astype(np.float32)
        c[:, 0] = c[:, 0] + ln * rng.standard_normal(c.shape[0]).astype(np.float32)
        np.clip(c, (time_shift + 1) / interval,
                (time_shift + hm.duration - 1) / interval, out=c)
        new_d["motion_opacity_center"] = c
        new_d["motion_opacity_var"] = np.full(
            (c.shape[0], 2), 2.0, np.float32
        )
        n_split_d = int(sd.sum())
        keep["motion_xyz_error_min"] = np.concatenate(
            [hm.stats["motion_xyz_error_min"], np.full((n_split_d * N,), 1000.0, np.float32)]
        )
        keep["motion_xyz_error_min_timestamp"] = np.concatenate(
            [hm.stats["motion_xyz_error_min_timestamp"],
             np.full((n_split_d * N,), -1.0, np.float32)]
        )
    _cat_rows(hm, new_s, new_d, keep_stats=keep)
    # prune the split originals
    drop_s = np.zeros(hm.n_static, bool)
    drop_s[:ss.shape[0]] = ss
    drop_d = np.zeros(hm.n_dynamic, bool)
    if hm.n_dynamic:
        drop_d[:sd.shape[0]] = sd
    _prune_rows(hm, drop_s, drop_d)

    # ---- prune (densify_and_prune, :1034-1070)
    with np.errstate(divide="ignore", invalid="ignore"):
        opa = 1.0 / (1.0 + np.exp(-hm.params["opacity"][:, 0]))
        drop_s = opa < min_opacity
        if max_screen_size:
            drop_s |= hm.stats["max_radii2D"] > max_screen_size
            drop_s |= np.exp(hm.params["scaling"]).max(axis=1) > 0.1 * extent
        l1 = hm.stats["xyz_error_accum"] / np.maximum(hm.stats["error_denom"], 1e-4)
        drop_s |= l1 > s_l1_thres
        sm = hm.stats["xyz_ssim_error_accum"] / np.maximum(hm.stats["error_denom"], 1e-4)
        drop_s |= (sm < s_max_ssim) & (sm > 0)

        drop_d = np.zeros((hm.n_dynamic,), bool)
        if hm.n_dynamic:
            mopa = 1.0 / (1.0 + np.exp(-hm.params["motion_opacity"][:, 0]))
            drop_d = mopa < min_motion_opacity
            dl1 = hm.stats["motion_xyz_error_mean"] / np.maximum(
                hm.stats["motion_error_denom"], 1e-4
            )
            drop_d |= dl1 > d_l1_thres
            dsm = hm.stats["motion_xyz_ssim_error_accum"] / np.maximum(
                hm.stats["motion_error_denom"], 1e-4
            )
            drop_d |= (dsm < d_max_ssim) & (dsm > 0)
            if max_dynamic_screen_size:
                drop_d |= hm.stats["motion_max_radii2D"] > max_dynamic_screen_size
                drop_d |= np.exp(hm.params["motion_scaling"]).max(axis=1) > 0.1 * extent
    _prune_rows(hm, drop_s, drop_d)


def prune_invisible(hm: HostModel) -> None:
    """Drop never-seen splats (c_gaussian_model.py:1074-1085)."""
    _prune_rows(
        hm,
        hm.stats["xyz_error_min_timestamp"] < 0,
        hm.stats["motion_xyz_error_min_timestamp"] < 0
        if hm.n_dynamic
        else np.zeros((0,), bool),
    )


def prune_small(hm: HostModel) -> None:
    """Drop splats that never exceeded 5px (c_gaussian_model.py:1087-1093)."""
    _prune_rows(
        hm,
        hm.stats["min_radii2D"] < 5,
        hm.stats["motion_min_radii2D"] < 5 if hm.n_dynamic else np.zeros((0,), bool),
    )


def prune_nan(hm: HostModel) -> None:
    """(c_gaussian_model.py:1229-1241)"""
    s = np.isnan(hm.params["xyz"]).any(axis=-1)
    d = (
        np.isnan(hm.params["motion_xyz"].reshape(hm.n_dynamic, -1)).any(axis=-1)
        if hm.n_dynamic
        else np.zeros((0,), bool)
    )
    if s.any() or d.any():
        _prune_rows(hm, s, d)


def reset_opacity(hm: HostModel) -> None:
    """Clamp opacities down (c_gaussian_model.py:549-558)."""
    opa = 1.0 / (1.0 + np.exp(-hm.params["opacity"]))
    new = np.minimum(opa, 0.85)
    _replace_param(hm, {"opacity": np.log(new / (1 - new))})
    if hm.n_dynamic:
        mopa = 1.0 / (1.0 + np.exp(-hm.params["motion_opacity"]))
        new = np.minimum(mopa, 0.95)
        _replace_param(hm, {"motion_opacity": np.log(new / (1 - new))})


def extract_dynamic_from_static(
    hm: HostModel,
    cfg: ModelConfig,
    viewpoint_loc: np.ndarray,
    timestamp: float,
    vis_filter: np.ndarray,
    extent: float,
    percentile: float = 0.98,
    motion_thres: float = 1000.0,
    min_motion_thres: float = 1e-6,
    max_dur: float | None = None,
) -> int:
    """Static->dynamic conversion (c_gaussian_model.py:1147-1227).

    Rank visible statics by camera-normalized displacement, convert the top
    (1-percentile) into keyframed dynamics seeded from the displacement line,
    with a temporal opacity window centered on their best-error timestamp.
    Returns the number of converted splats.
    """
    interval = cfg.time_interval
    time_shift = cfg.time_shift
    max_dur = hm.duration if max_dur is None else max(float(max_dur), interval)
    vis_filter = vis_filter[: hm.n_static].astype(bool)
    if vis_filter.sum() == 0:
        return 0

    disp_n = np.linalg.norm(hm.params["xyz_disp"][vis_filter], axis=-1)
    denorm = (
        np.linalg.norm(hm.params["xyz"][vis_filter] - viewpoint_loc[None, :], axis=-1)
        ** 2
    )
    disp = disp_n / (denorm + 1e-6)
    disp = disp / (disp.max() + 1e-6)
    mv_thresh = np.quantile(disp, percentile)

    full_disp = np.linalg.norm(hm.params["xyz_disp"], axis=-1)
    dyn = (disp > mv_thresh) | (full_disp[vis_filter] > motion_thres * extent)
    dyn &= full_disp[vis_filter] > min_motion_thres * extent
    conv = vis_filter.copy()
    conv[vis_filter] = dyn
    conv &= hm.stats["xyz_error_min_timestamp"] >= 0
    n = int(conv.sum())
    if n == 0:
        return 0

    if hm.keyframe_num == 0:
        hm.keyframe_num = (
            math.ceil((max_dur + time_shift * 2 + 1) / interval) + 1 + 2
        )
    kf = max(hm.keyframe_num, hm.params["motion_xyz"].shape[1]) or hm.keyframe_num
    # Bilinear expansion of the two-endpoint displacement line to kf keyframes
    # (the reference uses F.interpolate bilinear over [start, end], :1167-1170):
    start = hm.params["xyz"][conv] - hm.params["xyz_disp"][conv] * interval / max_dur
    end = hm.params["xyz"][conv] + hm.params["xyz_disp"][conv] * (1 + interval / max_dur)
    w = (
        (np.arange(kf, dtype=np.float32) + 0.5) / kf * 2.0 - 0.5
    ).clip(0.0, 1.0)  # align_corners=False bilinear weights over 2 source taps
    traj = start[:, None, :] * (1 - w)[None, :, None] + end[:, None, :] * w[None, :, None]

    t = hm.stats["xyz_error_min_timestamp"][conv][:, None]  # [n,1]
    opac = hm.params["opacity"][conv]
    center = np.concatenate(
        [
            (t * 0.5 + time_shift) / interval * np.ones_like(opac),
            ((max_dur + np.maximum(t, 0.0)) / 2 + time_shift) / interval
            * np.ones_like(opac),
        ],
        axis=1,
    ).clip((time_shift + 1) / interval, (time_shift + max_dur - 1) / interval)
    var = np.concatenate(
        [t + cfg.time_pad, (max_dur - t + cfg.time_pad)], axis=1
    ).astype(np.float32)

    new_d = {
        "motion_xyz": traj.astype(np.float32),
        "motion_f_dc": hm.params["f_dc"][conv].copy(),
        "motion_f_rest": hm.params["f_rest"][conv].copy(),
        "motion_scaling": hm.params["scaling"][conv].copy(),
        "motion_opacity": opac.copy(),
        "motion_opacity_center": center.astype(np.float32),
        "motion_opacity_var": var,
        "motion_rotation": np.repeat(
            hm.params["rotation"][conv][:, None, :], kf, axis=1
        ),
    }
    if "motion_xyz_d" in hm.params:
        # Seed cubic_diff tangents with the linear trajectory's per-keyframe
        # delta (the Hermite tangent that exactly reproduces the seed line).
        new_d["motion_xyz_d"] = np.repeat(
            ((end - start) / kf)[:, None, :], kf, axis=1
        ).astype(np.float32)
    # Ensure existing dynamic arrays have kf keyframes (pad by edge values).
    for k in KEYFRAME_KEYS:
        if k not in hm.params:
            continue
        cur = hm.params[k]
        if cur.shape[1] < kf:
            padw = kf - cur.shape[1]
            if cur.shape[1] == 0:
                edge = np.zeros((cur.shape[0], padw, cur.shape[2]), cur.dtype)
            else:
                edge = np.repeat(cur[:, -1:], padw, axis=1)
            hm.params[k] = np.concatenate([cur, edge], axis=1)
            for st in (hm.mu, hm.nu):
                st[k] = np.concatenate(
                    [st[k], np.zeros((st[k].shape[0], padw, st[k].shape[2]),
                                     st[k].dtype)], axis=1
                )

    # The extraction appends dynamics with reset accumulators for ALL
    # dynamics (:1213-1220) but error_min pairs only appended (:1222-1225).
    keep = {
        "motion_xyz_error_min": np.concatenate(
            [hm.stats["motion_xyz_error_min"], np.full((n,), 1000.0, np.float32)]
        ),
        "motion_xyz_error_min_timestamp": np.concatenate(
            [hm.stats["motion_xyz_error_min_timestamp"], np.full((n,), -1.0, np.float32)]
        ),
        # static stats survive untouched by this event
        **{k: hm.stats[k] for k in STATIC_STAT_KEYS},
    }
    _cat_rows(hm, None, new_d, keep_stats=keep)
    _prune_rows(hm, conv, np.zeros((hm.n_dynamic,), bool))
    return n


def expand_duration(hm: HostModel, cfg: ModelConfig, duration: float) -> bool:
    """Extend keyframe arrays by linear extrapolation (c_gaussian_model.py:1243-1297)."""
    interval = cfg.time_interval
    time_shift = cfg.time_shift
    duration = int(duration) + 1
    if duration <= hm.duration:
        return False
    if hm.n_dynamic == 0:
        hm.duration = duration
        return False
    require = (
        math.ceil((duration + time_shift + cfg.time_pad * 2 + 1) / interval) + 1 + 2
    )
    cur = hm.params["motion_xyz"].shape[1]
    num_expand = require - cur
    if num_expand < 1:
        hm.duration = duration
        return False

    num_avg = min(hm.keyframe_num - 2, 4) if hm.keyframe_num >= 3 else 1

    def lin_interp_last(x):
        diff = (x[:, -num_avg:] - x[:, -num_avg - 1:-num_avg]).mean(axis=1, keepdims=True)
        steps = np.arange(1, num_expand + 1, dtype=np.float32).reshape(
            1, -1, *([1] * (x.ndim - 2))
        )
        return np.concatenate([x, steps * diff + x[:, -1:]], axis=1).astype(np.float32)

    new_xyz = lin_interp_last(hm.params["motion_xyz"])
    new_rot = lin_interp_last(hm.params["motion_rotation"])
    new_xyz_d = (
        lin_interp_last(hm.params["motion_xyz_d"])
        if "motion_xyz_d" in hm.params else None
    )

    var = hm.params["motion_opacity_var"].copy()
    cond = (
        hm.params["motion_opacity_center"] + time_shift / interval
        > (duration + time_shift) / interval - 0.5
    ).any(axis=1)
    var[:, 1] = np.where(cond, 1.0, var[:, 1])
    center = hm.params["motion_opacity_center"].clip(
        max=(time_shift + hm.duration - 1) / interval
    )

    # keyframe-extended params replace their moments with zero state of the
    # NEW shape (replace_tensor_to_optimizer zeroes them, :672-691)
    hm.params["motion_xyz"] = new_xyz
    hm.params["motion_rotation"] = new_rot
    for st in (hm.mu, hm.nu):
        st["motion_xyz"] = np.zeros_like(new_xyz)
        st["motion_rotation"] = np.zeros_like(new_rot)
    if new_xyz_d is not None:
        hm.params["motion_xyz_d"] = new_xyz_d
        for st in (hm.mu, hm.nu):
            st["motion_xyz_d"] = np.zeros_like(new_xyz_d)
    _replace_param(hm, {"motion_opacity_center": center, "motion_opacity_var": var})
    hm.keyframe_num = require
    hm.duration = duration
    return True


def adjust_temp_opa(hm: HostModel, cfg: ModelConfig, max_dur: float | None = None) -> None:
    """Re-widen temporal opacity windows pinned at the sequence ends
    (c_gaussian_model.py:1330-1358)."""
    if hm.n_dynamic == 0:
        return
    interval = cfg.time_interval
    time_shift = cfg.time_shift
    max_dur = hm.duration if max_dur is None else float(max_dur)
    c = hm.params["motion_opacity_center"]
    v = hm.params["motion_opacity_var"].copy()
    hi = (c > (max_dur + time_shift) / interval - 0.2).any(axis=1)
    lo = (c < time_shift / interval + 0.2).any(axis=1)
    v[:, 1] = np.where(hi, np.maximum(v[:, 1], 1.0) * 2, v[:, 1])
    v[:, 0] = np.where(lo, np.maximum(v[:, 0], 1.0) * 2, v[:, 0])
    new_c = c.clip(time_shift / interval + 0.2, (max_dur + time_shift) / interval - 0.2)
    v = np.where(hm.params["motion_opacity_var"] < 0.5, 0.5, v)
    _replace_param(hm, {"motion_opacity_center": new_c.astype(np.float32),
                        "motion_opacity_var": v.astype(np.float32)})
