"""4D Gaussian Splatting (Yang et al., ICLR 2024) on the port's normal path:
the slice and the 4D harmonics (`ops/slice4d.py`), `rendering.render4d`
and `train.step.train_step_4d`, held on the CPU to the plain reference
`gsbench/reference_fourdgs.py` (float64), and on the card (marker `cuda`)
the kernel pair against its plain version and the step's graph replay
against its eager call. The file imports no JAX, so its card cases run
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fourdgs.py

Each tolerance says why it is what it is; each is tight enough that the
reference computed in bfloat16 fails it (checked beside it).
"""
import ast
import dataclasses
import math
import pathlib

import numpy as np
import pytest
import torch

import gsbench.reference_fourdgs as FR
from ex4dgs_tpu_torch import kernels
from ex4dgs_tpu_torch.kernel_config import KernelConfig
from ex4dgs_tpu_torch.models import state4d
from ex4dgs_tpu_torch.models.config import Model4DConfig, Optimization4DConfig
from ex4dgs_tpu_torch.models.optimizer import fourdgs_lrs, init_state
from ex4dgs_tpu_torch.ops import slice4d as S
from ex4dgs_tpu_torch.ops.math3d import cov3d_from_scaling_rotation
from ex4dgs_tpu_torch.ops.projection import project_gaussians
from ex4dgs_tpu_torch.rendering import default_capacity, render4d
from ex4dgs_tpu_torch.runtime import graphs
from ex4dgs_tpu_torch.synthetic import ring_cameras
from ex4dgs_tpu_torch.train import step as step_mod

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SPAN = 10.0
W, H = 64, 48
FLIP = (1.0, -1.0, -1.0, 1.0)  # (u, u * FLIP) rotates xyz and fixes t


def _unit(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _params(P: int, seed: int, kind: str = "random", rows: int = 48) -> dict:
    """Seeded 4D Gaussians in float64 in front of the test cameras. kind:
    random rotations; identity (quaternions (c, 0, 0, 0), c != 1);
    floor (time-fixing rotations, barely mixed, and a time scale under
    every spatial one, so Sigma_tt sits at its floor, the least scale
    squared); far (time means far from the times asked for)."""
    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64)

    def n(*shape):
        return torch.randn(shape, generator=g, **f64)

    def u(*shape):
        return torch.rand(shape, generator=g, **f64)

    p = {"xyz": n(P, 3) * 0.6, "t": u(P, 1) * SPAN, "scaling": n(P, 3) * 0.3 - 2.5,
         "scaling_t": n(P, 1) * 0.3 - 0.3, "rotation": n(P, 4), "rotation_r": n(P, 4),
         "opacity": n(P, 1), "f_dc": n(P, 1, 3), "f_rest": n(P, rows - 1, 3) * 0.3}
    if kind == "identity":
        p["rotation"] = torch.zeros(P, 4, **f64)
        p["rotation"][:, 0] = 1.7
        p["rotation_r"] = p["rotation"].clone()
    elif kind == "floor":
        q = _unit(n(P, 4))
        p["rotation"] = q + 1e-3 * n(P, 4)
        p["rotation_r"] = q * torch.tensor(FLIP, **f64) + 1e-3 * n(P, 4)
        p["scaling_t"] = torch.full((P, 1), -4.0, **f64)
    elif kind == "far":
        p["t"] = u(P, 1) * 0.5
    return p


def _mask(P: int, seed: int):
    return torch.rand(P, generator=torch.Generator().manual_seed(seed + 1)) > 0.1


def _cast(p: dict, dtype) -> dict:
    return {k: v.to(dtype) for k, v in p.items()}


def _ref_slice(p, mask, t, campos, deg=3, deg_t=2):
    sl = FR.slice_at(p, mask, t, campos, SPAN, deg, deg_t)
    cov = torch.stack([sl.cov3[:, i, j] for i, j in S._PACK], -1)
    return sl.means, cov, sl.opacity, sl.rgb, sl.live


def _port_slice(p, mask, t, campos, deg=3, deg_t=2):
    return S.slice4d_plain(*(p[k] for k in S.PARAMS), mask, torch.tensor(t, dtype=p["xyz"].dtype),
                           campos, deg, deg_t, span=SPAN)


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b| (0 where both are 0)."""
    den = float(b.double().abs().max())
    return float((a.double() - b.double()).abs().max()) / den if den > 0 else float(
        (a.double() - b.double()).abs().max())


# ---------------------------------------------------------------------------
# the slice and the harmonics
# ---------------------------------------------------------------------------

# float32 slicing of values of order 1 (ops/slice4d.py says why it is
# what it is); bfloat16 misses by two orders.
SLICE_RTOL = S.SLICE_RTOL


@pytest.mark.parametrize("kind", ["random", "identity", "floor", "far"])
def test_slice_matches_the_reference(kind):
    P, t = 300, 5.0
    p, mask = _params(P, 11, kind), _mask(P, 11)
    campos = torch.tensor([0.3, -0.5, -4.0], dtype=torch.float64)
    want = _ref_slice(p, mask, t, campos)
    p32 = _cast(_cast(p, torch.float32), torch.float64)  # the inputs as float32 holds them
    want32 = _ref_slice(p32, mask, t, campos)
    got = _port_slice(_cast(p, torch.float32), mask, t, campos.float())
    bf16 = _ref_slice(_cast(p, torch.bfloat16), mask, t, campos.to(torch.bfloat16))
    for i, name in enumerate(("mean", "cov3d", "alpha", "rgb")):
        assert _rel(got[i], want32[i]) < SLICE_RTOL, (kind, name, _rel(got[i], want32[i]))
        if kind != "far" or name != "alpha":  # alpha is 0 far from mu_t
            assert _rel(bf16[i], want[i]) > SLICE_RTOL, (kind, name)
    assert torch.equal(got[4], want32[4]), kind
    assert not got[4][~mask].any()
    if kind == "far":
        assert not got[4].any() and float(got[2].max()) <= S.MARGINAL_MIN
    else:
        assert 0 < int(got[4].sum()) < int(mask.sum())


def test_rotation_is_orthogonal_with_determinant_one():
    p = _params(200, 3)
    for R in (S._rotation(p["rotation"], p["rotation_r"])[0],
              FR.rotation_4d(p["rotation"], p["rotation_r"])):
        eye = torch.eye(4, dtype=torch.float64).expand(200, 4, 4)
        assert float((R @ R.transpose(1, 2) - eye).abs().max()) < 1e-14
        assert float((torch.linalg.det(R) - 1).abs().max()) < 1e-13


def _quat_of(rot):
    """(w, x, y, z) of 3x3 rotation matrices (the largest of the four
    squares first, so no division is small)."""
    out = []
    for m in rot:
        m = m.tolist()
        tr = m[0][0] + m[1][1] + m[2][2]
        cands = [1 + tr, 1 + m[0][0] - m[1][1] - m[2][2], 1 - m[0][0] + m[1][1] - m[2][2],
                 1 - m[0][0] - m[1][1] + m[2][2]]
        k = int(np.argmax(cands))
        s = 2 * math.sqrt(cands[k])
        if k == 0:
            q = [s / 4, (m[2][1] - m[1][2]) / s, (m[0][2] - m[2][0]) / s, (m[1][0] - m[0][1]) / s]
        elif k == 1:
            q = [(m[2][1] - m[1][2]) / s, s / 4, (m[0][1] + m[1][0]) / s, (m[0][2] + m[2][0]) / s]
        elif k == 2:
            q = [(m[0][2] - m[2][0]) / s, (m[0][1] + m[1][0]) / s, s / 4, (m[1][2] + m[2][1]) / s]
        else:
            q = [(m[1][0] - m[0][1]) / s, (m[0][2] + m[2][0]) / s, (m[1][2] + m[2][1]) / s, s / 4]
        out.append(q)
    return torch.tensor(out, dtype=torch.float64)


def test_uncorrelated_slice_is_the_3d_covariance():
    """A rotation that fixes t (the pair u, u with i and j negated) leaves
    xyz and t uncorrelated: the sliced covariance is the 3D Gaussian's
    R3 S^2 R3^T, as cov3d_from_scaling_rotation gives it from R3's
    quaternion, the mean stays at mu_xyz and the marginal has variance
    exp(2 s_t)."""
    P = 100
    p = _params(P, 5)
    u = _unit(torch.randn(P, 4, generator=torch.Generator().manual_seed(9), dtype=torch.float64))
    p["rotation"], p["rotation_r"] = u, u * torch.tensor(FLIP, dtype=torch.float64)
    R = S._rotation(p["rotation"], p["rotation_r"])[0]
    assert float(R[:, :3, 3].abs().max()) < 1e-15 and float((R[:, 3, 3] - 1).abs().max()) < 1e-15
    mask = torch.ones(P, dtype=torch.bool)
    mean, cov, alpha, _, _ = _port_slice(p, mask, 4.0, torch.zeros(3, dtype=torch.float64))
    want = cov3d_from_scaling_rotation(torch.exp(p["scaling"]), _quat_of(R[:, :3, :3]))
    assert float((cov - want).abs().max()) < 1e-15
    assert float((mean - p["xyz"]).abs().max()) < 1e-14  # c is 0 to rounding
    marg = torch.exp(-0.5 * (4.0 - p["t"][:, 0]) ** 2 / torch.exp(2 * p["scaling_t"][:, 0]))
    assert float((alpha - torch.sigmoid(p["opacity"][:, 0]) * marg).abs().max()) < 1e-15


# float32 harmonics of 48 rows of O(1) features: sums of ~50 terms of a
# few ulps each; bfloat16 misses by two orders.
RGB_RTOL = 1e-5


@pytest.mark.parametrize("deg_t", [0, 1, 2])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_harmonics_at_every_degree(deg, deg_t):
    P, t = 200, 3.3
    p, mask = _params(P, 21), _mask(P, 21)
    campos = torch.tensor([0.1, 0.4, -3.0], dtype=torch.float64)
    want = _ref_slice(p, mask, t, campos, deg, deg_t)[3]
    got = _port_slice(_cast(p, torch.float32), mask, t, campos.float(), deg, deg_t)[3]
    p32 = _cast(_cast(p, torch.float32), torch.float64)
    assert _rel(got, _ref_slice(p32, mask, t, campos, deg, deg_t)[3]) < RGB_RTOL
    bf16 = _ref_slice(_cast(p, torch.bfloat16), mask, t, campos.to(torch.bfloat16), deg, deg_t)[3]
    assert _rel(bf16, want) > RGB_RTOL
    # the degrees matter: one less in space or in time changes the colour
    for d, dt_ in ((deg - 1, deg_t), (deg, deg_t - 1)):
        if d >= 0 and dt_ >= 0:
            assert _rel(_ref_slice(p, mask, t, campos, d, dt_)[3], want) > 1e-3


@pytest.mark.parametrize("kind", ["random", "floor"])
def test_plain_backward_is_autograd_of_the_reference(kind):
    """In float64 the hand-derived gradients equal autograd's through the
    reference's 4x4 matrices to rounding (1e-12 of each leaf's largest)."""
    P, t = 300, 5.0
    p, mask = _params(P, 31, kind), _mask(P, 31)
    campos = torch.tensor([0.2, 0.1, -4.0], dtype=torch.float64)
    g = torch.Generator().manual_seed(7)
    cots = [torch.randn(s, generator=g, dtype=torch.float64) for s in ((P, 3), (P, 6), (P,),
                                                                      (P, 3))]
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    outs = _ref_slice(leaves, mask, t, campos)[:4]
    want = torch.autograd.grad(outs, [leaves[k] for k in S.PARAMS], grad_outputs=cots)
    got = S.slice4d_bwd_plain(*(p[k] for k in S.PARAMS), torch.tensor(t, dtype=torch.float64),
                              campos, 3, 2, *cots, span=SPAN)
    for k, a, b in zip(S.PARAMS, got, want):
        assert a.shape == b.shape, k
        assert _rel(a, b) < 1e-12, (k, _rel(a, b))


def test_autograd_function_runs_the_plain_versions_on_the_cpu():
    P = 100
    p = {k: v.float() for k, v in _params(P, 41).items()}
    mask = _mask(P, 41)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    campos = torch.tensor([0.0, 0.0, -4.0])
    before = dict(kernels.launches)
    mean, cov, alpha, rgb, live = S.slice4d(leaves, mask, 5.0, campos, 3, 2, span=SPAN)
    loss = mean.sum() + cov.sum() + alpha.sum() + rgb.sum()
    grads = torch.autograd.grad(loss, [leaves[k] for k in S.PARAMS])
    want = S.slice4d_bwd_plain(*(p[k] for k in S.PARAMS), torch.tensor(5.0), campos,
                               torch.tensor(3), torch.tensor(2), torch.ones(P, 3),
                               torch.ones(P, 6), torch.ones(P), torch.ones(P, 3), span=SPAN)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    assert kernels.launches == before and live.dtype == torch.bool


# ---------------------------------------------------------------------------
# the model, the projection keyword, the frame
# ---------------------------------------------------------------------------

def test_state_round_trips_and_raises_degrees():
    cfg = Model4DConfig()
    m = state4d.empty_model(cfg, 5000, device="cpu")
    assert m.capacity == 8192 and m.params["f_rest"].shape == (8192, 47, 3)
    assert not m.mask.any() and float(m.params["rotation"][:, 0].min()) == 1.0
    m.mask[:10] = True
    back = state4d.model_from_numpy(**state4d.model_to_numpy(m), device="cpu")
    for k in state4d.PARAM_KEYS:
        assert torch.equal(back.params[k], m.params[k])
    assert torch.equal(back.mask, m.mask)
    bad = state4d.model_to_numpy(m)
    bad["params"]["t"] = bad["params"]["t"][:, 0]
    with pytest.raises(ValueError, match="param t"):
        state4d.model_from_numpy(**bad, device="cpu")
    for _ in range(4):
        m = state4d.oneup_sh_degree(m, cfg.sh_degree, cfg.sh_degree_t)
    assert int(m.active_sh_degree) == 3 and int(m.active_sh_degree_t) == 2


def test_compensation_default_is_ex4dgs_projection():
    """The keyword's default is the compensated dilation (Ex4DGS's), bit for
    bit; compensate=False dilates alike and leaves the opacity as it is."""
    g = torch.Generator().manual_seed(4)
    P = 500
    means = torch.randn(P, 3, generator=g) * 0.7
    cov = cov3d_from_scaling_rotation(torch.exp(torch.randn(P, 3, generator=g) - 2.5),
                                      _unit(torch.randn(P, 4, generator=g)))
    opac = torch.rand(P, generator=g)
    cam = ring_cameras(1, 3.0, W, H, device="cpu")[0]
    kw = dict(width=W, height=H, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, kernel_size=0.1)
    a = project_gaussians(means, cov, opac, cam.arrays, **kw)
    b = project_gaussians(means, cov, opac, cam.arrays, compensate=True, **kw)
    c = project_gaussians(means, cov, opac, cam.arrays, compensate=False, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(c.opacity, opac) and torch.equal(c.conic, a.conic)
    assert float((a.opacity - opac).abs().max()) > 1e-3  # the compensation scales


def _host_cam(cam) -> dict:
    """The reference's host camera of a RenderCamera."""
    return {"view": cam.view.numpy(), "proj": cam.proj.numpy(), "campos": cam.campos.numpy(),
            "width": cam.width, "height": cam.height,
            "fovx": 2 * math.atan(float(cam.tan_fovx)), "fovy": 2 * math.atan(float(cam.tan_fovy))}


CFG = {"dilation": 0.3, "near": 0.2, "far": 100.0, "tile": [16, 16], "exact_sort": True,
       "lambda_dssim": 0.2, "adam_eps": 1e-15, "densify_until_iter": 15000,
       "position_lr_init": 0.00016, "position_lr_final": 1.6e-06, "position_lr_delay_mult": 0.01,
       "position_lr_max_steps": 30000, "feature_lr": 0.0025, "opacity_lr": 0.05,
       "scaling_lr": 0.005, "rotation_lr": 0.001}
MCFG = Model4DConfig(near=CFG["near"], far=CFG["far"], dilation=CFG["dilation"],
                     time_duration=(0.0, SPAN))
KCFG = KernelConfig(tile_x=16, tile_y=16, exact_sort=True)
INFO = {"sh_degree": 3, "sh_degree_t": 2, "span": SPAN}


def _model(p: dict, mask) -> state4d.Gaussian4DModel:
    i32 = dict(dtype=torch.int32)
    return state4d.Gaussian4DModel(params={k: v.float().contiguous() for k, v in p.items()},
                                   mask=mask, stats=state4d.empty_stats(mask.shape[0], "cpu"),
                                   active_sh_degree=torch.tensor(3, **i32),
                                   active_sh_degree_t=torch.tensor(2, **i32))


def _scene(P=600, seed=51):
    p = _params(P, seed)
    p["opacity"] = p["opacity"] + 1.0
    return p, _mask(P, seed)


def test_render4d_matches_the_reference_frame():
    """64x48, 16x16 tiles, exact depth order: the port's float32 frame
    against the float64 reference's. Float32 compositing of a few hundred
    splats differs by ~1e-6 at a pixel; 1e-4 leaves room, bfloat16 misses
    it by far."""
    p, mask = _scene()
    model = _model(p, mask)
    bg = torch.tensor([0.1, 0.3, 0.2])
    for i, cam in enumerate(ring_cameras(2, 3.0, W, H, device="cpu")):
        t = 2.5 + 4 * i
        res = render4d(cam, model, MCFG, t=t, bg=bg, kernel_cfg=KCFG, device="cpu")
        host = _host_cam(cam)
        want, _ = FR.render(_cast(model.params, torch.float64), mask, INFO, CFG, host, t,
                            bg.double())
        low, _ = FR.render(_cast(model.params, torch.bfloat16), mask, INFO, CFG, host, t,
                           bg.to(torch.bfloat16))
        err = float((res.render.double() - want).abs().max())
        assert err < 1e-4, err
        assert float((low.double() - want).abs().max()) > 1e-4
        assert float((want - bg.double()).abs().max()) > 0.1  # splats in view
        assert int(res.visibility_filter.sum()) > 20
        assert not res.visibility_filter[~mask].any()


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _views(V: int, seed: int):
    cams = ring_cameras(V, 3.0, W, H, device="cpu")
    g = torch.Generator().manual_seed(seed)
    gts = [torch.rand((H, W, 3), generator=g) for _ in cams]
    ts = [1.0 + 2.3 * i for i in range(V)]
    return cams, gts, ts


def _statics(capacity=None):
    opt = Optimization4DConfig()
    cap = capacity or default_capacity(1024, W, H, KCFG)
    return step_mod.Step4DStatics(cfg=MCFG, opt=opt, spatial_lr_scale=2.0, capacity=cap,
                                  kernel=KCFG)


# Float32 against float64 over a frame and its gradient: the loss to 1e-6
# of itself; each leaf's gradient and Adam moments to 1e-3 of the leaf's
# largest (one splat's gradient sums a few hundred pixels' float32 terms,
# and near-ties of the exact sort swap none at this size); bfloat16 misses
# both.
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-3


@pytest.mark.parametrize("V", [2, 4])
def test_train_step_4d_matches_the_reference(V):
    p, mask = _scene()
    model = _model(p, mask)
    state = init_state(model.params, device="cpu")
    cams, gts, ts = _views(V, 61)
    bg = torch.tensor([0.5, 0.2, 0.7])
    it = 10_000
    out = step_mod.train_step_4d(model, state, cams, gts, ts, bg, it, _statics(), device="cpu")
    p64 = _cast(model.params, torch.float64)
    views = [FR.View(_host_cam(c), t, gt.double()) for c, t, gt in zip(cams, ts, gts)]
    ref = FR.train_step(p64, FR.init_state(p64), FR.init_stats(mask, torch.float64, "cpu"), mask,
                        INFO, CFG, views, bg.double(), it, 2.0)
    assert abs(float(out.loss) - ref.loss) < LOSS_RTOL * ref.loss
    g = {k: v / (1 - FR.BETA1) for k, v in out.opt_state.mu.items()}  # mu = (1 - beta1) g
    for k in state4d.PARAM_KEYS:
        assert _rel(g[k], ref.grads[k]) < GRAD_RTOL, (k, _rel(g[k], ref.grads[k]))
        assert _rel(out.opt_state.nu[k], ref.state["nu"][k]) < 2 * GRAD_RTOL, k
        # Adam's first step moves each element by its rate times sign(g):
        # compare where the gradient is not round-off
        big = ref.grads[k].abs() > 1e-3 * float(ref.grads[k].abs().max())
        # to 1e-3 of itself, and the float32 storing of the new value (2 ulps)
        step = (out.model.params[k].double() - p64[k])[big]
        want = (ref.params[k] - p64[k])[big]
        ulp = torch.finfo(torch.float32).eps * p64[k][big].abs()
        assert bool(((step - want).abs() <= 1e-3 * want.abs() + 2 * ulp).all()), k
    assert int(out.opt_state.step) == 1 and ref.state["step"] == 1
    for k in state4d.STAT_KEYS:
        assert _rel(out.model.stats[k], ref.stats[k]) < GRAD_RTOL, (k, out.model.stats[k].sum())
    assert int(out.model.stats["denom"].sum()) > 20
    assert torch.equal(out.model.stats["denom"] > 0, out.visibility & mask)
    # the bfloat16 reference misses the gradient's tolerance
    pb = _cast(model.params, torch.bfloat16)
    low = FR.train_step(pb, FR.init_state(pb), FR.init_stats(mask, torch.bfloat16, "cpu"), mask,
                        INFO, CFG, [v._replace(gt=v.gt.to(torch.bfloat16)) for v in views],
                        bg.to(torch.bfloat16), it, 2.0)
    assert max(_rel(low.grads[k], ref.grads[k]) for k in state4d.PARAM_KEYS) > GRAD_RTOL


def test_overflow_leaves_the_state_bit_equal():
    p, mask = _scene()
    model = _model(p, mask)
    state = init_state(model.params, device="cpu")
    cams, gts, ts = _views(4, 71)
    out = step_mod.train_step_4d(model, state, cams, gts, ts, torch.zeros(3), 10_000,
                                 _statics(capacity=64), device="cpu")
    assert int(out.binning_total) > 64
    for k in state4d.PARAM_KEYS:
        assert torch.equal(out.model.params[k], model.params[k])
        assert torch.equal(out.opt_state.mu[k], state.mu[k])
    for k in state4d.STAT_KEYS:
        assert torch.equal(out.model.stats[k], model.stats[k])
    assert int(out.opt_state.step) == 0 and not bool(out.nan_flag)


def test_lrs_follow_the_recipe():
    lrs = fourdgs_lrs(Optimization4DConfig(), 2.0, 30_000)
    assert float(lrs["xyz"]) == pytest.approx(1.6e-6 * 2.0, rel=1e-5)
    assert lrs["t"] is lrs["xyz"] and lrs["f_rest"] == pytest.approx(0.0025 / 20)
    assert lrs["rotation_r"] == lrs["rotation"] == 0.001


def test_the_reference_copies_are_one_file_importing_nothing_of_the_program():
    """The tests and the benchmark share one reference file, which imports
    nothing of the program."""
    assert pathlib.Path(FR.__file__).resolve() == ROOT / "gsbench" / "reference_fourdgs.py"
    assert not (ROOT / "tests" / "fourdgs_reference.py").exists()
    for path in (ROOT / "gsbench" / "reference_fourdgs.py", ROOT / "gsbench" / "reference.py"):
        roots = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert roots <= {"__future__", "math", "typing", "numpy", "torch", "gsbench"}, roots


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the slicing kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "identity", "floor", "far", "cell"])
def test_kernels_match_the_plain_versions_on_the_card(cuda_device, kind):
    """Forward and backward kernels against slice4d_plain and
    slice4d_bwd_plain in float32 on the card, at 100,003 Gaussians (not a
    multiple of the block) and, in `cell`, on the n3v_4dgs cell's model
    (gsbench's draw of gsbench/configs/n3v_4dgs.json: 500,000 Gaussians in
    503,808 rows), every degree pair of the last band, two launches
    bit-equal. The kernels fuse what the plain versions round, so they
    agree to SLICE_RTOL of each output's largest value; the 0.05 marginal
    test may flip at a rounding in 2 rows per 100,000."""
    dev = cuda_device
    if kind == "cell":
        import json

        from gsbench.families import fourdgs

        cfg = json.loads((ROOT / "gsbench" / "configs" / "n3v_4dgs.json").read_text())
        sc = fourdgs.make_params(cfg, 18, dev)
        p, mask = sc["params"], sc["mask"]
        at, campos = 3.7, torch.tensor([1.5, 4.0, -11.5], device=dev)
    else:
        p = {k: v.float().to(dev) for k, v in _params(100_003, 81, kind).items()}
        mask = _mask(100_003, 81).to(dev)
        at, campos = 5.0, torch.tensor([0.3, -0.5, -4.0], device=dev)
    P = mask.shape[0]
    g = torch.Generator(device=dev).manual_seed(3)
    cots = [torch.randn(s, generator=g, device=dev) for s in ((P, 3), (P, 6), (P,), (P, 3))]
    for deg, deg_t in ((3, 2), (2, 1), (0, 0)):
        args = ([p[k] for k in S.PARAMS], torch.tensor(at, device=dev), campos,
                torch.tensor(deg, dtype=torch.int32, device=dev),
                torch.tensor(deg_t, dtype=torch.int32, device=dev))
        params, t, cp, d, dt_ = args
        got = kernels.slice4d_fwd(*params, mask, t, cp, d, dt_, span=SPAN)
        again = kernels.slice4d_fwd(*params, mask, t, cp, d, dt_, span=SPAN)
        want = S.slice4d_plain(*params, mask, t, cp, d, dt_, span=SPAN)
        for a, b, c in zip(got, want, again):
            assert torch.equal(a, c)
            if a.dtype == torch.bool:
                assert int((a != b).sum()) <= max(2, P // 50_000)
            else:
                assert _rel(a, b) < SLICE_RTOL, (kind, deg, deg_t, _rel(a, b))
        gk = kernels.slice4d_bwd(*params, t, cp, d, dt_, *cots, span=SPAN)
        gk2 = kernels.slice4d_bwd(*params, t, cp, d, dt_, *cots, span=SPAN)
        gp = S.slice4d_bwd_plain(*params, t, cp, d, dt_, *cots, span=SPAN)
        for name, a, b, c in zip(S.PARAMS, gk, gp, gk2):
            assert torch.equal(a, c), name
            # a gradient sums the same terms in another order (ops/slice4d.py)
            assert _rel(a, b) < S.SLICE_BWD_RTOL, (kind, deg, deg_t, name, _rel(a, b))


@pytest.mark.cuda
def test_train_step_4d_replay_is_bit_equal_to_its_eager_call(cuda_device):
    """Five steps of four views through eager call, capture and replays,
    the views, times and background changing, against the same five steps
    each run eagerly: every tensor of the state and every small output
    equal bit for bit; the slicing kernels and the pack VJP launched once
    per view each way."""
    dev = cuda_device
    P = 20_000
    p = {k: v.float() for k, v in _params(P, 91).items()}
    p["opacity"] = p["opacity"] + 1.0
    mask = _mask(P, 91)
    Wc, Hc = 160, 96
    cams = ring_cameras(6, 3.0, Wc, Hc, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    gts = [torch.rand((Hc, Wc, 3), generator=g, device=dev) for _ in cams]
    statics = dataclasses.replace(_statics(), capacity=default_capacity(P, Wc, Hc, KCFG))

    def fresh():
        m = _model(p, mask)
        m = dataclasses.replace(m, params={k: v.to(dev) for k, v in m.params.items()},
                                mask=m.mask.to(dev), stats={k: v.to(dev) for k, v in
                                                            m.stats.items()},
                                active_sh_degree=m.active_sh_degree.to(dev),
                                active_sh_degree_t=m.active_sh_degree_t.to(dev))
        return m, init_state(m.params, device=dev)

    def run(eager: bool):
        m, st = fresh()
        rows = []
        for i in range(5):
            if eager:
                graphs.release()
            views = [(i + j) % len(cams) for j in range(4)]
            out = step_mod.train_step_4d(m, st, [cams[j] for j in views], [gts[j] for j in views],
                                         [0.5 + 2.1 * i + 0.7 * j for j in range(4)],
                                         torch.rand(3, generator=g, device=dev), 10_000 + i,
                                         statics, device=dev)
            pack_launches.append(kernels.launches["pack_vjp"])
            m, st = out.model, out.opt_state
            state = {**{f"p.{k}": v for k, v in m.params.items()},
                     **{f"s.{k}": v for k, v in m.stats.items()},
                     **{f"mu.{k}": v for k, v in st.mu.items()},
                     **{f"nu.{k}": v for k, v in st.nu.items()}}
            rows.append(({k: v.clone() for k, v in state.items()},
                         [out.loss, out.binning_total, out.nan_flag, out.visibility]))
        return rows

    pack_launches = []  # the pack VJP's count after each call
    g.manual_seed(5)
    eager = run(True)
    kernels.reset_launches()
    kernels.reset_graph_calls()
    g.manual_seed(5)
    graphed = run(False)
    torch.cuda.synchronize()
    assert kernels.graph_call_counts(dev) == {"eager": 1, "captures": 1, "replays": 4}
    assert kernels.launches["slice4d_fwd"] == kernels.launches["slice4d_bwd"] == 20
    # one pack VJP a view: the eager call, the capture and each replay
    assert pack_launches[-5:] == [4, 8, 12, 16, 20], pack_launches
    for (ws, wo), (gs, go) in zip(eager, graphed):
        for k in ws:
            assert torch.equal(ws[k].view(torch.int32) if ws[k].is_floating_point() else ws[k],
                               gs[k].view(torch.int32) if gs[k].is_floating_point() else gs[k]), k
        for a, b in zip(wo, go):
            assert torch.equal(a, b)
        assert not bool(go[2]) and math.isfinite(float(go[0]))
    graphs.release()
