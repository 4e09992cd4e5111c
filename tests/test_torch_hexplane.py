"""4D-GS (Wu et al., CVPR 2024) on the port's normal path: the HexPlane
field (`ops/hexplane.py`), the deformation (`models/deform.py`),
`rendering.render_deform` and `train.step.train_step_deform`, held on the
CPU to the plain reference `gsbench/reference_hexplane.py` (float64) at a
small size with seeded random weights, and on the card (marker `cuda`) the
kernel pair against its plain version and the step's graph replay against
its eager call. The file imports no JAX, so its card cases run where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_hexplane.py

Each tolerance says why it is what it is; each is tight enough that the
reference computed in bfloat16 fails it (checked beside it).
"""
import ast
import dataclasses
import json
import math
import pathlib

import pytest
import torch
import torch.nn.functional as F

import gsbench.reference_hexplane as HR
from ex4dgs_tpu_torch import kernels
from ex4dgs_tpu_torch.kernel_config import KernelConfig
from ex4dgs_tpu_torch.models import deform as D
from ex4dgs_tpu_torch.models.config import ModelDeformConfig, OptimizationDeformConfig
from ex4dgs_tpu_torch.models.optimizer import deform_lrs, init_state
from ex4dgs_tpu_torch.models.state4d import STAT_KEYS, empty_stats
from ex4dgs_tpu_torch.ops import hexplane as H
from ex4dgs_tpu_torch.ops.losses import plane_regularizers
from ex4dgs_tpu_torch.rendering import default_capacity, render_deform
from ex4dgs_tpu_torch.runtime import graphs
from ex4dgs_tpu_torch.synthetic import ring_cameras
from ex4dgs_tpu_torch.train import step as step_mod
from gsbench.families import hexplane as fam

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "gsbench" / "configs" / "n3v_hexplane.json").read_text())
W, H_ = 64, 48
KCFG = KernelConfig(tile_x=16, tile_y=16, exact_sort=True)
MCFG = ModelDeformConfig(multires=tuple(CFG["multires"]),
                         resolution=tuple(CFG["kplanes_config"]["resolution"]),
                         near=CFG["near"], far=CFG["far"], dilation=CFG["dilation"])
# the published widths, a small cloud in front of the ring cameras
SMALL = {"n_gaussians": 600, "cloud_std": 0.5, "splat_size": [0.04, 0.12]}


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b| (0 where both are 0)."""
    den = float(b.double().abs().max())
    d = float((a.double() - b.double()).abs().max())
    return d / den if den > 0 else d


def _planes(seed: int, dtype=torch.float64, res=(8, 9, 10, 7)):
    """Two scales of six small planes [16, R_b, R_a] (axis cells `res` for
    x, y, z, t; the spatial ones doubled at the second scale), spatial
    planes uniform in [0.1, 0.5], time ones about one."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for s in (1, 2):
        r = [x * s for x in res[:3]] + [res[3]]
        for a, b in H.PAIRS:
            shape = (16, r[b], r[a])
            if b == 3:
                out.append(1 + 0.1 * torch.randn(shape, generator=g, dtype=dtype))
            else:
                out.append(0.1 + 0.4 * torch.rand(shape, generator=g, dtype=dtype))
    return out


def _coords(P: int, seed: int, dtype=torch.float64):
    """Points inside and outside the box (x, y, z in [-1.3, 1.3]), t in
    [0, 1), some at t = 0 and t = 1 and some on the border exactly."""
    g = torch.Generator().manual_seed(seed)
    c = torch.rand(P, 4, generator=g, dtype=dtype) * 2.6 - 1.3
    c[:, 3] = torch.rand(P, generator=g, dtype=dtype)
    c[:8, 3] = 0.0
    c[8:16, 3] = 1.0
    c[16:24, 0] = 1.0
    c[24:32, 1] = -1.0
    return c


def _field(planes) -> dict:
    return {f"grid.{n // 6}.{n % 6}": p for n, p in enumerate(planes)}


# ---------------------------------------------------------------------------
# the field
# ---------------------------------------------------------------------------

# float32 bilinear samples and their products of values of order 1: a few
# ulps (6e-8 each); bfloat16 misses by two orders.
SAMPLE_RTOL = 1e-6


def test_sample_matches_grid_sample_and_the_reference():
    """The plain forward in float32 against F.grid_sample (align_corners,
    border) and against the reference's explicit lookups in float64, on
    points inside and outside the box, t at 0 and at 1."""
    planes, c = _planes(1), _coords(700, 2)
    got = H.hexplane_plain(c.float(), [p.float() for p in planes])
    want = HR.field(_field(planes), c)
    gs = []
    for s in range(2):
        f = 1.0
        for k, (a, b) in enumerate(H.PAIRS):
            grid = torch.stack([c[:, a], c[:, b]], -1).view(1, 1, -1, 2)
            f = f * F.grid_sample(planes[6 * s + k][None], grid, align_corners=True,
                                  padding_mode="border")[0, :, 0].T
        gs.append(f)
    gs = torch.cat(gs, -1)
    assert float((want - gs).abs().max()) < 1e-14  # the reference is grid_sample's
    assert _rel(got, want) < SAMPLE_RTOL, _rel(got, want)
    low = HR.field(_field([p.to(torch.bfloat16) for p in planes]), c.to(torch.bfloat16))
    assert _rel(low, want) > SAMPLE_RTOL
    # the border: a point past the box samples the edge, as at the edge
    edge = c.clone()
    edge[:, :3] = edge[:, :3].clamp(-1, 1)
    assert torch.equal(H.hexplane_plain(edge, planes), H.hexplane_plain(c, planes))


def test_backward_is_autograd_of_the_reference():
    """In float64 the hand-derived backward (through `HexPlane`) equals
    autograd through the reference's lookups, for the coordinates and every
    plane, to rounding (1e-12 of each leaf's largest); a coordinate at or
    past the border gets no gradient along its axis."""
    planes, c = _planes(3), _coords(500, 4)
    g = torch.randn(500, 32, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    leaves = [p.clone().requires_grad_(True) for p in planes]
    cl = c.clone().requires_grad_(True)
    want = torch.autograd.grad(HR.field(_field(leaves), cl), [cl, *leaves], grad_outputs=g)
    lp = [p.clone().requires_grad_(True) for p in planes]
    cp = c.clone().requires_grad_(True)
    got = torch.autograd.grad(H.hexplane(cp, lp), [cp, *lp], grad_outputs=g)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and _rel(a, b) < 1e-12, (i, _rel(a, b))
    outside = (c[:, 0].abs() >= 1)
    assert bool((got[0][outside, 0] == 0).all()) and bool(outside.any())


def test_autograd_function_runs_the_plain_versions_on_the_cpu():
    planes = [p.float() for p in _planes(6)]
    c = _coords(200, 7).float()
    before = dict(kernels.launches)
    leaves = [p.clone().requires_grad_(True) for p in planes]
    f = H.hexplane(c, leaves)
    grads = torch.autograd.grad(f.sum(), leaves)
    _, want = H.hexplane_bwd_plain(c, planes, torch.ones_like(f))
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    assert kernels.launches == before and torch.equal(f, H.hexplane_plain(c, planes))


# ---------------------------------------------------------------------------
# the model and the frame
# ---------------------------------------------------------------------------

def _scene(seed: int = 11, **over):
    """The family's seeded scene at the published widths, a small cloud."""
    return fam.make_params({**CFG, **SMALL, **over}, seed, "cpu")


def _model(sc) -> D.DeformModel:
    return D.DeformModel(params={k: v.clone() for k, v in sc["params"].items()},
                         mask=sc["mask"], stats=empty_stats(sc["mask"].shape[0], "cpu"),
                         aabb=sc["aabb"])


def _host_cam(cam) -> dict:
    return {"view": cam.view.numpy(), "proj": cam.proj.numpy(), "campos": cam.campos.numpy(),
            "width": cam.width, "height": cam.height,
            "fovx": 2 * math.atan(float(cam.tan_fovx)), "fovy": 2 * math.atan(float(cam.tan_fovy))}


def test_the_model_lays_out_the_published_field():
    sc = _scene()
    shapes = D.field_shapes(MCFG)
    assert {k: tuple(v.shape) for k, v in sc["params"].items() if k in shapes} == shapes
    planes = sum(math.prod(s) for k, s in shapes.items() if k.startswith("grid."))
    assert planes * 4 == 9_461_760  # 9.46 MB of planes
    macs = sum(s[0] * s[1] for k, s in shapes.items() if k.endswith(".weight"))
    assert macs == 93_568  # multiply-adds a Gaussian-view
    empty = D.empty_model(MCFG, 100, device="cpu")
    assert empty.capacity == 4096 and set(empty.params) == set(sc["params"])
    # the seeded field moves the cloud by deform_rms of its spread
    p = sc["params"]
    xyz, *_ = D.deform(p, sc["aabb"], 0.5, MCFG)
    n = sc["mask"]
    rms = float(((xyz - p["xyz"])[n] ** 2).sum(-1).mean().sqrt())
    assert 0.3 * SMALL["cloud_std"] * CFG["deform_rms"] < rms < 3 * SMALL["cloud_std"] * 0.02
    # and the deformation varies with t
    later, *_ = D.deform(p, sc["aabb"], 0.9, MCFG)
    assert float((later - xyz)[n].abs().max()) > 1e-3


# float32 against float64 over a frame: compositing a few hundred splats
# differs by ~1e-6 at a pixel; 1e-4 leaves room, bfloat16 misses by far.
FRAME_TOL = 1e-4


def test_render_deform_matches_the_reference_frame():
    sc = _scene()
    model = _model(sc)
    bg = torch.tensor([0.1, 0.3, 0.2])
    for i, cam in enumerate(ring_cameras(2, 3.0, W, H_, device="cpu")):
        t = 0.2 + 0.5 * i
        res = render_deform(cam, model, MCFG, t=t, bg=bg, kernel_cfg=KCFG, device="cpu")
        p64 = {k: v.double() for k, v in sc["params"].items()}
        want, _ = HR.render(p64, sc["mask"], sc["aabb"], CFG, _host_cam(cam), t, bg.double())
        pb = {k: v.to(torch.bfloat16) for k, v in sc["params"].items()}
        low, _ = HR.render(pb, sc["mask"], sc["aabb"], CFG, _host_cam(cam), t,
                           bg.to(torch.bfloat16))
        err = float((res.render.double() - want).abs().max())
        assert err < FRAME_TOL, err
        assert float((low.double() - want).abs().max()) > FRAME_TOL
        assert float((want - bg.double()).abs().max()) > 0.1  # splats in view
        assert int(res.visibility_filter.sum()) > 100
        assert not res.visibility_filter[~sc["mask"]].any()


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _views(V: int, seed: int):
    cams = ring_cameras(V, 3.0, W, H_, device="cpu")
    g = torch.Generator().manual_seed(seed)
    return cams, [torch.rand((H_, W, 3), generator=g) for _ in cams], [0.1 + 0.23 * i
                                                                       for i in range(V)]


def _statics(capacity=None):
    opt = OptimizationDeformConfig()
    cap = capacity or default_capacity(4096, W, H_, KCFG)
    return step_mod.Step4DStatics(cfg=MCFG, opt=opt, spatial_lr_scale=2.0, capacity=cap,
                                  kernel=KCFG)


# Float32 against float64 over the views and their gradient: the loss to
# 1e-6 of itself; each leaf's gradient and Adam moments to 1e-3 of the
# leaf's largest (a plane cell or an MLP weight sums some thousands of
# float32 terms); bfloat16 misses both.
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-3
IT = 9_000  # inside densification, so the statistics are compared too


@pytest.mark.parametrize("V", [1, 4])
def test_train_step_deform_matches_the_reference(V):
    sc = _scene()
    model = _model(sc)
    state = init_state(model.params, device="cpu")
    cams, gts, ts = _views(V, 61)
    bg = torch.tensor([0.5, 0.2, 0.7])
    out = step_mod.train_step_deform(model, state, cams, gts, ts, bg, IT, _statics(),
                                     device="cpu")
    p64 = {k: v.double() for k, v in sc["params"].items()}
    mask, aabb = sc["mask"], sc["aabb"]
    views = [HR.View(_host_cam(c), t, gt.double()) for c, t, gt in zip(cams, ts, gts)]
    ref = HR.train_step(p64, HR.init_state(p64), HR.init_stats(mask, torch.float64, "cpu"),
                        mask, aabb, CFG, views, bg.double(), IT, 2.0)
    reg = float(HR.regularizers(p64, CFG))
    assert 1e-5 < reg < 1e-2 * ref.loss  # the regularizers are in the loss, and small
    assert abs(float(out.loss) - ref.loss) < LOSS_RTOL * ref.loss
    g = {k: v / (1 - HR.BETA1) for k, v in out.opt_state.mu.items()}  # mu = (1 - beta1) g
    assert set(g) == set(ref.grads) and len(g) == 6 + 12 + 22
    # The rows that define the box lie on its border, where the field's
    # coordinate gradient jumps from its inner value to 0 and float32's
    # rounding of the normalisation picks the side: their xyz is compared
    # apart, through the image alone.
    edge = ((p64["xyz"] == aabb[0].double()) | (p64["xyz"] == aabb[1].double())).any(-1)
    assert 1 <= int(edge.sum()) <= 6
    for k in ref.grads:
        def cut(x):
            return x[~edge] if k == "xyz" else x

        rg, p0 = cut(ref.grads[k]), cut(p64[k])
        assert _rel(cut(g[k]), rg) < GRAD_RTOL, (k, _rel(cut(g[k]), rg))
        assert _rel(cut(out.opt_state.nu[k]), cut(ref.state["nu"][k])) < 2 * GRAD_RTOL, k
        big = rg.abs() > 1e-3 * float(rg.abs().max())
        step = (cut(out.model.params[k]).double() - p0)[big]
        want = (cut(ref.params[k]) - p0)[big]
        ulp = torch.finfo(torch.float32).eps * p0[big].abs()
        assert bool(((step - want).abs() <= 1e-3 * want.abs() + 2 * ulp).all()), k
    assert not out.opt_state.mu["f_dc"][~mask].any()  # rows outside the mask: no update
    assert int(out.opt_state.step) == 1
    for k in STAT_KEYS:
        assert _rel(out.model.stats[k], ref.stats[k]) < GRAD_RTOL, k
    assert int(out.model.stats["denom"].sum()) > 100
    pb = {k: v.to(torch.bfloat16) for k, v in sc["params"].items()}
    low = HR.train_step(pb, HR.init_state(pb), HR.init_stats(mask, torch.bfloat16, "cpu"), mask,
                        aabb, CFG, [v._replace(gt=v.gt.to(torch.bfloat16)) for v in views],
                        bg.to(torch.bfloat16), IT, 2.0)
    assert max(_rel(low.grads[k], ref.grads[k]) for k in ref.grads) > GRAD_RTOL


def test_plane_regularizers_match_the_reference():
    sc = _scene()
    p = sc["params"]
    keys = [k for k in p if k.startswith("grid.")]
    got = plane_regularizers([p[k] for k in keys], [D.time_plane(int(k[-1])) for k in keys],
                             CFG["plane_tv_weight"], CFG["time_smoothness_weight"],
                             CFG["l1_time_planes"])
    want = HR.regularizers({k: v.double() for k, v in p.items()}, CFG)
    assert abs(float(got) - float(want)) < 1e-6 * float(want)
    # a smooth plane has none: a ramp along the rows has no second difference
    ramp = torch.arange(10.0)[None, :, None].expand(16, 10, 4)
    assert float(plane_regularizers([ramp], [False], 1.0, 0.0, 0.0)) == 0.0


def test_overflow_leaves_the_state_bit_equal():
    sc = _scene()
    model = _model(sc)
    state = init_state(model.params, device="cpu")
    cams, gts, ts = _views(4, 71)
    out = step_mod.train_step_deform(model, state, cams, gts, ts, torch.zeros(3), IT,
                                     _statics(capacity=64), device="cpu")
    assert int(out.binning_total) > 64
    for k in model.params:
        assert torch.equal(out.model.params[k], model.params[k])
        assert torch.equal(out.opt_state.mu[k], state.mu[k])
    for k in STAT_KEYS:
        assert torch.equal(out.model.stats[k], model.stats[k])
    assert int(out.opt_state.step) == 0 and not bool(out.nan_flag)


# span -> its parent's name in a train_step_deform of one view
DEFORM_PARENTS = {"ex4dgs.deform": "ex4dgs.render", "ex4dgs.hexplane": "ex4dgs.deform",
                  "ex4dgs.deform_mlp": "ex4dgs.deform", "ex4dgs.plane_reg": "ex4dgs.train_step"}


def test_the_step_records_the_field_and_regularizer_spans(tmp_path):
    """Under torch.profiler a train_step_deform records the field's spans
    inside each view's render and the regularizers' inside the step, once
    a view, with their parents, and profiling.trace's spans.json lists
    them."""
    from torch.profiler import ProfilerActivity, profile

    from ex4dgs_tpu_torch.runtime import profiling

    sc = _scene()
    model = _model(sc)
    cams, gts, ts = _views(2, 81)

    def step():
        return step_mod.train_step_deform(model, init_state(model.params, device="cpu"), cams,
                                          gts, ts, torch.zeros(3), IT, _statics(), device="cpu")

    profiling.span_reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            step()
        recs = profiling._RECORD
        by_id = {r.span: r for r in recs}
        for name, parent in DEFORM_PARENTS.items():
            mine = [r for r in recs if r.name == name]
            assert len(mine) == (1 if name == "ex4dgs.plane_reg" else 2), name
            assert all(by_id[r.parent].name == parent for r in mine), name
        profiling.span_reset()
        with profiling.trace(str(tmp_path)):
            step()
        spans = json.loads((tmp_path / "spans.json").read_text())
        assert spans["calls"] == 1 and set(DEFORM_PARENTS) <= set(spans["per_call"])
    finally:
        profiling.span_reset()


def test_deform_lrs_follow_the_recipe():
    opt = OptimizationDeformConfig()
    names = list(D.row_shapes(8)) + list(D.field_shapes(MCFG))
    start, end = (deform_lrs(opt, 2.0, it, names) for it in (0, 20_000))
    for k, (a, b) in {"xyz": (1.6e-4, 1.6e-6), "grid.1.4": (1.6e-3, 1.6e-4),
                      "feature_out.0.weight": (1.6e-4, 1.6e-5),
                      "shs_deform.3.bias": (1.6e-4, 1.6e-5)}.items():
        assert float(start[k]) == pytest.approx(2.0 * a, rel=1e-5), k
        assert float(end[k]) == pytest.approx(2.0 * b, rel=1e-5), k
    mid = deform_lrs(opt, 2.0, 10_000, names)
    assert float(mid["grid.0.0"]) == pytest.approx(2.0 * math.sqrt(1.6e-3 * 1.6e-4), rel=1e-5)
    fixed = {"f_dc": 2.5e-3, "f_rest": 2.5e-3 / 20, "opacity": 0.05, "scaling": 5e-3,
             "rotation": 1e-3}
    for k, v in fixed.items():
        assert mid[k] == pytest.approx(v)
    ref = HR.learning_rates(CFG, 2.0, 10_000, names)
    for k in names:
        assert float(mid[k]) == pytest.approx(ref[k], rel=1e-5), k


def test_the_reference_file_imports_nothing_of_the_program():
    """The tests and the benchmark share one reference file, which imports
    nothing of the program, and sets TF32 off."""
    path = ROOT / "gsbench" / "reference_hexplane.py"
    assert pathlib.Path(HR.__file__).resolve() == path
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert roots <= {"__future__", "math", "typing", "numpy", "torch", "gsbench"}, roots
    assert "allow_tf32 = False" in path.read_text()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the HexPlane kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "cell"])
def test_kernels_match_the_plain_versions_on_the_card(cuda_device, kind):
    """Forward and backward kernels against hexplane_plain and
    hexplane_bwd_plain in float32 on the card, at the published widths (2
    scales of 16 channels, resolutions (64, 64, 64, 150) and twice the
    spatial ones): in `random` 300,007 points (not a multiple of the block)
    in and out of the box, in `cell` the n3v_hexplane cell's seeded scene
    (gsbench's draw of gsbench/configs/n3v_hexplane.json: 300,000 Gaussians
    in 303,104 rows) at t = 0.37. The forward equals the plain version to
    HEX_RTOL (the same roundings), the backward to HEX_BWD_RTOL
    (ops/hexplane.py says why); two launches of each give the same bits."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(3)
    if kind == "cell":
        sc = fam.make_params(CFG, 22, dev)
        p = sc["params"]
        lo, hi = sc["aabb"]
        c = (p["xyz"] - lo) * (2.0 / (hi - lo)) - 1.0
        coords = torch.cat([c, torch.full_like(c[:, :1], 0.37)], -1).contiguous()
        planes = [p[k] for k in H.plane_keys(2)]
    else:
        planes = [v.to(dev) for k, v in fam.make_params({**CFG, "n_gaussians": 8}, 5, dev)[
            "params"].items() if k.startswith("grid.")]
        coords = torch.rand((300_007, 4), generator=g, device=dev) * 2.4 - 1.2
        coords[:, 3] = torch.rand(300_007, generator=g, device=dev)
    P = coords.shape[0]
    cot = torch.randn((P, 32), generator=g, device=dev) * 1e-3
    got = kernels.hexplane_fwd(coords, planes)
    again = kernels.hexplane_fwd(coords, planes)
    want = H.hexplane_plain(coords, planes)
    assert torch.equal(got, again)
    assert _rel(got, want) < H.HEX_RTOL, _rel(got, want)
    gc, gp = kernels.hexplane_bwd(coords, planes, cot)
    gc2, gp2 = kernels.hexplane_bwd(coords, planes, cot)
    wc, wp = H.hexplane_bwd_plain(coords, planes, cot)
    assert torch.equal(gc, gc2) and all(torch.equal(a, b) for a, b in zip(gp, gp2))
    assert _rel(gc, wc) < H.HEX_BWD_RTOL, _rel(gc, wc)
    for n, (a, b) in enumerate(zip(gp, wp)):
        assert _rel(a, b) < H.HEX_BWD_RTOL, (n, _rel(a, b))


@pytest.mark.cuda
def test_train_step_deform_replay_is_bit_equal_to_its_eager_call(cuda_device):
    """Five steps of four views through eager call, capture and replays,
    the views, times and background changing, against the same five steps
    each run eagerly: every tensor of the state and every small output
    equal bit for bit (the HexPlane backward's fixed-point sums repeat);
    the HexPlane kernels launched once per view each way."""
    dev = cuda_device
    sc = fam.make_params({**CFG, **SMALL, "n_gaussians": 20_000, "cloud_std": 0.6}, 91, dev)
    Wc, Hc = 160, 96
    cams = ring_cameras(6, 3.0, Wc, Hc, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    gts = [torch.rand((Hc, Wc, 3), generator=g, device=dev) for _ in cams]
    statics = dataclasses.replace(_statics(), capacity=default_capacity(20_480, Wc, Hc, KCFG))

    def run(eager: bool):
        m = D.DeformModel(params={k: v.clone() for k, v in sc["params"].items()},
                          mask=sc["mask"], stats=empty_stats(sc["mask"].shape[0], dev),
                          aabb=sc["aabb"])
        st = init_state(m.params, device=dev)
        rows = []
        for i in range(5):
            if eager:
                graphs.release()
            views = [(i + j) % len(cams) for j in range(4)]
            out = step_mod.train_step_deform(m, st, [cams[j] for j in views],
                                             [gts[j] for j in views],
                                             [0.05 + 0.17 * i + 0.03 * j for j in range(4)],
                                             torch.rand(3, generator=g, device=dev), 9_000 + i,
                                             statics, device=dev)
            m, st = out.model, out.opt_state
            state = {**{f"p.{k}": v for k, v in m.params.items()},
                     **{f"s.{k}": v for k, v in m.stats.items()},
                     **{f"mu.{k}": v for k, v in st.mu.items()},
                     **{f"nu.{k}": v for k, v in st.nu.items()}}
            rows.append(({k: v.clone() for k, v in state.items()},
                         [out.loss, out.binning_total, out.nan_flag, out.visibility]))
        return rows

    g.manual_seed(5)
    eager = run(True)
    kernels.reset_launches()
    kernels.reset_graph_calls()
    g.manual_seed(5)
    graphed = run(False)
    torch.cuda.synchronize()
    assert kernels.graph_call_counts(dev) == {"eager": 1, "captures": 1, "replays": 4}
    assert kernels.launches["hexplane_fwd"] == kernels.launches["hexplane_bwd"] == 20
    for (ws, wo), (gs, go) in zip(eager, graphed):
        for k in ws:
            assert torch.equal(ws[k].view(torch.int32) if ws[k].is_floating_point() else ws[k],
                               gs[k].view(torch.int32) if gs[k].is_floating_point() else gs[k]), k
        for a, b in zip(wo, go):
            assert torch.equal(a, b)
        assert not bool(go[2]) and math.isfinite(float(go[0]))
    graphs.release()
