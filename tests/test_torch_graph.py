"""train_step and a no-gradient render as CUDA graphs (train/step.py,
rendering.py, runtime/graphs.py): the graphs' bookkeeping and keys on the
CPU, and on the card (marker `cuda`) the graphed step against the eager
step and the replayed render against the eager render, bit for bit. The
file imports no JAX, so its card cases run where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_graph.py
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch import kernels
from ex4dgs_tpu_torch.kernel_config import KernelConfig
from ex4dgs_tpu_torch.models import state4d
from ex4dgs_tpu_torch.models.config import Model4DConfig, Optimization4DConfig, OptimizationConfig
from ex4dgs_tpu_torch.models.optimizer import fourdgs_lrs, group_lrs, init_state
from ex4dgs_tpu_torch.ops import interpolation as tint
from ex4dgs_tpu_torch import rendering as R
from ex4dgs_tpu_torch.rendering import RenderCamera, default_capacity, render
from ex4dgs_tpu_torch.runtime import graphs
from ex4dgs_tpu_torch.synthetic import make_scene, ring_cameras
from ex4dgs_tpu_torch.train import step as S

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph captures and replays only on the card")
    return torch.device("cuda")


@pytest.fixture
def counters():
    """kernels.launches and the graph calls from zero, restored afterwards."""
    launches = dict(kernels.launches)
    calls = [{k: dict(v) for k, v in c.items()}
             for c in (kernels.graph_calls, kernels.render_graph_calls)]
    kernels.reset_launches()
    kernels.reset_graph_calls()
    yield
    kernels.launches.update(launches)
    kernels.reset_graph_calls()
    kernels.graph_calls.update(calls[0])
    kernels.render_graph_calls.update(calls[1])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: NaN where the other has NaN, and the sign of 0."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def _state(model, opt_state) -> dict:
    """Every tensor of a model and its optimizer state, by name."""
    out = {f"params.{k}": v for k, v in model.params.items()}
    out.update({f"stats.{k}": v for k, v in model.stats.items()})
    out.update({f"mu.{k}": v for k, v in opt_state.mu.items()})
    out.update({f"nu.{k}": v for k, v in opt_state.nu.items()})
    out["step"] = opt_state.step
    return out


SMALL = ("loss", "ll1", "psnr", "visibility", "binning_total", "nan_flag")


def _scene(device, W=64, H=48):
    model, cfg = make_scene(n_static=300, n_dynamic=30, duration=10.0, seed=2, device=device)
    cam = ring_cameras(1, 3.0, W, H, far=cfg.far, device=device)[0]
    g = torch.Generator().manual_seed(3)
    gt = torch.rand((H, W, 3), generator=g).to(device)
    cap = default_capacity(model.static_capacity + model.dynamic_capacity, W, H)
    statics = S.StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                            capacity=cap)
    return model, cfg, cam, gt, statics


# ---------------------------------------------------------------------------
# CPU: bookkeeping, key, the staged step
# ---------------------------------------------------------------------------

def test_launches_count_replays(counters):
    """A launch a graph captures is not counted then (it did not run) but on
    each replay; a launch outside the capture counts at once."""
    with kernels.capturing() as tally:
        kernels.count_launch("composite_fwd", True)
        kernels.count_launch("composite_bwd", True)
        kernels.count_launch("composite_fwd", False)  # another stream: it ran
    assert tally["composite_fwd"] == 1 and tally["composite_bwd"] == 1
    assert kernels.launches["composite_fwd"] == 1 and kernels.launches["composite_bwd"] == 0
    for _ in range(3):
        kernels.replayed(tally)
    assert kernels.launches["composite_fwd"] == 4 and kernels.launches["composite_bwd"] == 3
    kernels.count_launch("composite_bwd", True)  # no capture under way: counted
    assert kernels.launches["composite_bwd"] == 4


def test_graph_calls_count_by_device_and_reset(counters):
    assert kernels.graph_call_counts("cpu") == {"eager": 0, "captures": 0, "replays": 0}
    for kind in ("eager", "captures", "replays", "replays"):
        kernels.count_graph_call("cuda:1", kind)
    assert kernels.graph_call_counts("cuda:1") == {"eager": 1, "captures": 1, "replays": 2}
    assert kernels.graph_call_counts("cuda:0")["replays"] == 0
    kernels.reset_graph_calls()
    assert kernels.graph_call_counts("cuda:1")["replays"] == 0


def test_graph_key_holds_what_a_capture_bakes_in():
    """Equal for another frame, timestamp and iteration with the same
    gates on the same state tensors; another key for copies of the state,
    a gate the iteration flips, another image size or other statics."""
    model, cfg, cam, gt, statics = _scene("cpu")
    state = init_state(model.params, device="cpu")
    bg = torch.zeros(3)
    key = S._graph_key(model, state, cam, gt, bg, 700, statics)
    assert key == S._graph_key(model, state, cam, torch.rand_like(gt), torch.ones(3), 701,
                               statics)
    assert key != S._graph_key(*S.clone_state(model, state), cam, gt, bg, 700, statics)
    past = statics.opt.densify_until_iter
    assert key != S._graph_key(model, state, cam, gt, bg, past, statics)
    small = ring_cameras(1, 3.0, 32, 48, far=cfg.far, device="cpu")[0]
    assert key != S._graph_key(model, state, small, gt, bg, 700, statics)
    bigger = S.StepStatics(cfg=cfg, opt=statics.opt, spatial_lr_scale=1.0,
                           capacity=statics.capacity * 2)
    assert key != S._graph_key(model, state, cam, gt, bg, 700, bigger)


def test_stage_scalars_keeps_the_rates_bits():
    opt = OptimizationConfig()
    lrs = group_lrs(opt, 3.0, 1234)
    got = graphs.stage_scalars(7.25, lrs, torch.empty(1 + len(lrs)))
    want = [np.float32(7.25)] + [np.float32(float(v)) for v in lrs.values()]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.float32))
    rates = S._rates(got, lrs)
    assert list(rates) == list(lrs) and all(r.dim() == 0 for r in rates.values())


def test_clone_state_copies_every_tensor():
    model, _cfg, _cam, _gt, _statics = _scene("cpu")
    state = init_state(model.params, device="cpu")
    m2, s2 = S.clone_state(model, state)
    a, b = _state(model, state), _state(m2, s2)
    assert a.keys() == b.keys()
    for k in a:
        assert _same_bits(a[k], b[k]) and a[k].data_ptr() != b[k].data_ptr(), k
    assert m2.static_mask.data_ptr() != model.static_mask.data_ptr()


@pytest.mark.parametrize("overflow", [False, True])
def test_step_as_the_card_stages_it_is_the_cpu_step(overflow):
    """The step with t and the rates staged in a tensor (the keyframes
    gathered by a tensor index) and the result written into the state in
    place, as the card runs it, gives the CPU step's bits; with an
    overflow it leaves the state bit for bit as it was."""
    model, _cfg, cam, gt, statics = _scene("cpu")
    if overflow:
        statics = S.StepStatics(cfg=statics.cfg, opt=statics.opt, spatial_lr_scale=1.0,
                                capacity=64)
    state = init_state(model.params, device="cpu")
    m2, s2 = S.clone_state(model, state)
    before = {k: v.clone() for k, v in _state(model, state).items()}
    bg = torch.tensor([0.1, 0.2, 0.3])
    it, t = 700, 7.0  # t on a keyframe boundary (time_shift 8, interval 5)
    want = S.train_step(model, state, cam, gt, t, bg, it, statics, device="cpu")
    lrs = group_lrs(statics.opt, statics.spatial_lr_scale, it)
    scalars = graphs.stage_scalars(t, lrs, torch.empty(1 + len(lrs)))
    got = S._step(m2, s2, cam, gt, scalars[0], scalars[0], bg, it, S._rates(scalars, lrs),
                  statics, torch.device("cpu"), in_place=True)
    w, g, m = _state(want.model, want.opt_state), _state(got.model, got.opt_state), _state(m2, s2)
    for k in w:
        assert _same_bits(g[k], w[k]), k
        assert g[k] is m[k], k  # written in place
    for f in SMALL:
        assert _same_bits(getattr(got, f), getattr(want, f)), f
    assert (int(got.binning_total) > statics.capacity) == overflow
    if overflow:
        for k, v in before.items():
            assert _same_bits(g[k], v), k


def _scene_4d(device, V=4, W=64, H=48):
    """A 4D Gaussian Splatting model of 400 Gaussians in 512 rows, V views
    at 16x16 exact sort, the step's statics."""
    model = state4d.empty_model(Model4DConfig(), 512, device=device)
    g = torch.Generator().manual_seed(6)
    P = 400
    p = model.params
    p["xyz"][:P] = torch.randn(P, 3, generator=g) * 0.6
    p["t"][:P] = torch.rand(P, 1, generator=g) * 10
    p["scaling"][:P] = torch.randn(P, 3, generator=g) * 0.3 - 2.5
    p["scaling_t"][:P] = torch.randn(P, 1, generator=g) * 0.3
    p["rotation"][:P] = torch.randn(P, 4, generator=g)
    p["rotation_r"][:P] = torch.randn(P, 4, generator=g)
    p["opacity"][:P] = torch.randn(P, 1, generator=g) + 1
    p["f_dc"][:P] = torch.randn(P, 1, 3, generator=g)
    p["f_rest"][:P] = torch.randn(P, 47, 3, generator=g) * 0.3
    model.mask[:P] = True
    model = model.replace(active_sh_degree=torch.tensor(3, dtype=torch.int32),
                          active_sh_degree_t=torch.tensor(2, dtype=torch.int32))
    cams = ring_cameras(V, 3.0, W, H, device=device)
    gts = [torch.rand((H, W, 3), generator=g).to(device) for _ in cams]
    kcfg = KernelConfig(tile_x=16, tile_y=16, exact_sort=True)
    statics = S.Step4DStatics(cfg=Model4DConfig(), opt=Optimization4DConfig(),
                              spatial_lr_scale=2.0, capacity=default_capacity(512, W, H, kcfg),
                              kernel=kcfg)
    return model, cams, gts, statics


def test_graph_key_4d_holds_views_shapes_and_the_adam_state():
    """train_step_4d's key is equal for other images, times and an
    iteration with the same gate on the same state tensors; another key for
    fewer views, another view size, copies of the Adam state, the
    statistics' gate flipped, or other statics."""
    model, cams, gts, statics = _scene_4d("cpu")
    state = init_state(model.params, device="cpu")
    bg = torch.zeros(3)
    key = S._graph_key_4d(model, state, cams, gts, bg, 10_000, statics)
    assert key == S._graph_key_4d(model, state, cams[::-1], [torch.rand_like(x) for x in gts],
                                  torch.ones(3), 10_001, statics)
    assert key != S._graph_key_4d(model, state, cams[:3], gts[:3], bg, 10_000, statics)
    small = ring_cameras(1, 3.0, 32, 48, device="cpu")[0]
    assert key != S._graph_key_4d(model, state, [small, *cams[1:]], gts, bg, 10_000, statics)
    assert key != S._graph_key_4d(model, init_state(model.params, device="cpu"), cams, gts, bg,
                                  10_000, statics)
    assert key != S._graph_key_4d(*S.clone_state(model, state), cams, gts, bg, 10_000, statics)
    past = statics.opt.densify_until_iter
    assert key != S._graph_key_4d(model, state, cams, gts, bg, past, statics)
    bigger = dataclasses.replace(statics, capacity=statics.capacity * 2)
    assert key != S._graph_key_4d(model, state, cams, gts, bg, 10_000, bigger)


def test_stage_scalars_takes_a_time_per_view():
    lrs = fourdgs_lrs(Optimization4DConfig(), 2.0, 12_000)
    ts = [0.5, torch.tensor(2.25), 7.0, 9.75]
    got = graphs.stage_scalars(ts, lrs, torch.empty(len(ts) + len(lrs)))
    want = [0.5, 2.25, 7.0, 9.75] + [np.float32(float(v)) for v in lrs.values()]
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.float32))
    assert list(S._rates(got, lrs, first=4)) == list(lrs)
    assert float(S._rates(got, lrs, first=4)["t"]) == np.float32(float(lrs["xyz"]))


@pytest.mark.parametrize("overflow", [False, True])
def test_step_4d_as_the_card_stages_it_is_the_cpu_step(overflow):
    """train_step_4d's work with the times and rates staged in a tensor and
    the result written into the state in place, as the card runs it, gives
    the CPU step's bits; with an overflow the state stays as it was."""
    model, cams, gts, statics = _scene_4d("cpu")
    if overflow:
        statics = dataclasses.replace(statics, capacity=64)
    state = init_state(model.params, device="cpu")
    m2, s2 = S.clone_state(model, state)
    before = {k: v.clone() for k, v in _state(model, state).items()}
    bg = torch.tensor([0.1, 0.2, 0.3])
    it, ts = 10_000, [1.5, 4.0, 6.25, 9.0]
    want = S.train_step_4d(model, state, cams, gts, ts, bg, it, statics, device="cpu")
    lrs = fourdgs_lrs(statics.opt, statics.spatial_lr_scale, it)
    scalars = graphs.stage_scalars(ts, lrs, torch.empty(len(ts) + len(lrs)))
    got = S._step4d(m2, s2, cams, gts, [scalars[i] for i in range(4)], bg, it,
                    S._rates(scalars, lrs, first=4), statics, torch.device("cpu"), in_place=True)
    w, g, m = _state(want.model, want.opt_state), _state(got.model, got.opt_state), _state(m2, s2)
    for k in w:
        assert _same_bits(g[k], w[k]), k
        assert g[k] is m[k], k  # written in place
    for f in ("loss", "visibility", "binning_total", "nan_flag"):
        assert _same_bits(getattr(got, f), getattr(want, f)), f
    assert (int(got.binning_total) > statics.capacity) == overflow
    if overflow:
        for k, v in before.items():
            assert _same_bits(g[k], v), k


# ---------------------------------------------------------------------------
# CPU: the render's graph
# ---------------------------------------------------------------------------

def _render_opts(statics, **changes) -> dict:
    """render's options as the benchmark's viewer passes them, changed."""
    return {"capacity": statics.capacity, "scaling_modifier": 1.0, "track_idx": False,
            "kernel_cfg": None, **changes}


_RENDER_KEY_CHANGES = {
    "model storage": lambda m, cfg, cam, o: (
        S.clone_state(m, init_state(m.params, device="cpu"))[0], cfg, cam, o),
    "camera size": lambda m, cfg, cam, o: (m, cfg, ring_cameras(1, 3.0, 32, 48, far=cfg.far,
                                                                 device="cpu")[0], o),
    "capacity": lambda m, cfg, cam, o: (m, cfg, cam, {**o, "capacity": 2 * o["capacity"]}),
    "kernel config": lambda m, cfg, cam, o: (m, cfg, cam, {
        **o, "kernel_cfg": KernelConfig(tile_x=16, tile_y=16, exact_sort=True)}),
    "scaling modifier": lambda m, cfg, cam, o: (m, cfg, cam, {**o, "scaling_modifier": 0.5}),
    "track_idx": lambda m, cfg, cam, o: (m, cfg, cam, {**o, "track_idx": True}),
    "near": lambda m, cfg, cam, o: (m, cfg, cam, {**o, "near": 0.5}),
    "model config": lambda m, cfg, cam, o: (m, dataclasses.replace(cfg, kernel_size=0.3), cam,
                                            o),
}


@pytest.mark.parametrize("change", [*_RENDER_KEY_CHANGES, "mode"])
def test_render_graph_key_holds_what_a_capture_bakes_in(change):
    """The render's key changes with each thing a capture bakes in: the
    model's storage, the camera's size, the capacity, the kernel config,
    the scaling modifier, track_idx, near, the model config and mode."""
    model, cfg, cam, _gt, statics = _scene("cpu")
    opts, bg = _render_opts(statics), torch.zeros(3)
    key = R._graph_key(cam, model, cfg, bg, 0, opts)
    if change == "mode":
        assert key != R._graph_key(cam, model, cfg, bg, 1, opts)
        return
    m2, cfg2, cam2, opts2 = _RENDER_KEY_CHANGES[change](model, cfg, cam, opts)
    assert key != R._graph_key(cam2, m2, cfg2, bg, 0, opts2)


def test_render_graph_key_leaves_out_the_staged_values():
    """Another camera of the same size, another bg and another t give the
    same key (they are staged), and so do the default kernel config given
    as None or as KernelConfig()."""
    model, cfg, cam, _gt, statics = _scene("cpu")
    opts = _render_opts(statics)
    key = R._graph_key(cam, model, cfg, torch.zeros(3), 0, opts)
    other = ring_cameras(3, 4.0, cam.width, cam.height, far=cfg.far, device="cpu")[2]
    assert not torch.equal(other.view, cam.view)
    assert key == R._graph_key(other, model, cfg, torch.tensor([0.3, 0.2, 0.9]), 0, opts)
    assert key == R._graph_key(cam, model, cfg, torch.zeros(3), 0,
                               {**opts, "kernel_cfg": KernelConfig()})


def _same_frame(got, want, track_idx: bool):
    for f in ("render", "depth", "opticalflow", "acc", "radii", "visibility_filter",
              "binning_total") + (("dominent_idxs",) if track_idx else ()):
        assert _same_bits(getattr(got, f), getattr(want, f)), f
    assert got.static_num == want.static_num


@pytest.mark.parametrize("t,track_idx", [(7.0, False), (float(np.nextafter(np.float32(7.0),
                                                                           np.float32(-1)))
                                                         , True), (2.5, True)])
def test_render_as_the_card_stages_it_is_the_cpu_render(t, track_idx):
    """The render as the card's graph runs it, the camera packed in one
    buffer, bg and the camera copied into static buffers and t staged as a
    0-d tensor (the keyframes gathered by a tensor index), gives today's
    host-t render bit for bit, on and beside a keyframe boundary (time
    shift 8, interval 5)."""
    model, cfg, cam, _gt, statics = _scene("cpu")
    bg = torch.tensor([0.1, 0.2, 0.3])
    opts = _render_opts(statics, track_idx=track_idx)
    host = RenderCamera(view=cam.view.clone(), proj=cam.proj.clone(), campos=cam.campos.clone(),
                        width=cam.width, height=cam.height, tan_fovx=cam.tan_fovx.clone(),
                        tan_fovy=cam.tan_fovy.clone())
    want = render(host, model, cfg, t=t, bg=bg, device="cpu", **opts)
    inputs = [getattr(cam, f) for f in graphs.CAMERA_TENSORS] + [bg]
    static = [torch.empty_like(x) for x in inputs]
    for a, x in zip(static, inputs):
        a.copy_(x)
    staged = dataclasses.replace(cam, **dict(zip(graphs.CAMERA_TENSORS, static)))
    scalars = graphs.stage_scalars([t], {}, torch.empty(1))
    got = R._render_at(staged, model, cfg, scalars[0], static[-1], 0, torch.device("cpu"), opts)
    _same_frame(got, want, track_idx)


def test_camera_from_numpy_packs_one_buffer():
    """The five fields are views of one float32 buffer, with the values
    given."""
    rng = np.random.default_rng(5)
    view, proj, campos = rng.normal(size=(4, 4)), rng.normal(size=(4, 4)), rng.normal(size=3)
    cam = RenderCamera.from_numpy(view, proj, campos, 64, 48, 0.5, 0.25, device="cpu")
    base = cam.view.untyped_storage().data_ptr()
    for f, v in zip(graphs.CAMERA_TENSORS, (view, proj, campos, 0.5, 0.25)):
        x = getattr(cam, f)
        assert x.dtype == torch.float32 and x.untyped_storage().data_ptr() == base, f
        np.testing.assert_array_equal(x.numpy(), np.asarray(v, np.float32))
    assert (cam.width, cam.height) == (64, 48)


@pytest.mark.parametrize("field", graphs.CAMERA_TENSORS)
def test_camera_from_numpy_rejects_wrong_shapes(field):
    good = {"view": np.eye(4), "proj": np.eye(4), "campos": np.zeros(3), "tan_fovx": 0.5,
            "tan_fovy": 0.5}
    bad = {**good, field: np.zeros((3, 3) if field in ("view", "proj") else (2,))}
    with pytest.raises(ValueError, match=f"camera {field}"):
        RenderCamera.from_numpy(bad["view"], bad["proj"], bad["campos"], 64, 48,
                                bad["tan_fovx"], bad["tan_fovy"], device="cpu")


def test_a_new_step_key_releases_the_render_graph(counters):
    """A training step's eager call (a new key) drops the card's render
    graph with its own, and a render's new key leaves the step's graph."""
    dev = torch.device("cpu")
    graphs.release()
    graphs._GRAPHS[("render", dev)] = graphs.Graph(("a render",))
    graphs._GRAPHS[("train_step", torch.device("cuda", 7))] = graphs.Graph(("elsewhere",))

    def body(inputs, scalars):
        return scalars.clone()

    out = graphs.run("render", dev, ("another render",), [], [1.5], {}, body, lambda o: o)
    assert float(out[0]) == 1.5 and ("train_step", torch.device("cuda", 7)) in graphs._GRAPHS
    graphs._GRAPHS[("train_step", dev)] = graphs.Graph(("a step",))
    graphs.run("train_step", dev, ("a new step",), [], [2.5], {"xyz": 1e-3}, body,
               lambda o: o, releases=("render",))
    assert ("render", dev) not in graphs._GRAPHS
    assert graphs._GRAPHS[("train_step", dev)].key == ("a new step",)
    assert ("train_step", torch.device("cuda", 7)) in graphs._GRAPHS  # another card's
    assert kernels.graph_call_counts(dev, "render") == {"eager": 1, "captures": 0, "replays": 0}
    assert kernels.graph_call_counts(dev) == {"eager": 1, "captures": 0, "replays": 0}
    graphs.release()
    assert not graphs._GRAPHS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_keyframe_index_on_the_card_is_the_hosts(cuda_device):
    """The device path's float32 floor((t + shift) / interval) on the card
    equals the host's, on keyframe boundaries and beside them (a division
    by a host number would be a multiplication by its reciprocal there)."""
    for interval, shift in [(5, 8), (5, 3), (2, 1), (3.3, 2.5), (0.7, 0), (3, 0), (7, 0.1),
                            (0.3, 0.6)]:
        base = np.arange(-2, 60, dtype=np.float32) * np.float32(interval) - np.float32(shift)
        ts = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                             np.nextafter(base, np.float32(-np.inf))]).astype(np.float32)
        got = torch.stack([tint.keyframe_coords(torch.tensor(t, device=cuda_device), shift,
                                                interval)[0] for t in ts]).cpu().tolist()
        want = [tint.keyframe_index(t, shift, interval) for t in ts]
        assert got == want, (interval, shift)


def _card_scene(dev):
    """The sync test's scene: 3000 static + 300 dynamic splats at 160x96,
    four ring cameras and a frame for each."""
    model, cfg = make_scene(n_static=3000, n_dynamic=300, duration=10.0, seed=1, device=dev)
    W, H = 160, 96
    cams = ring_cameras(4, 3.0, W, H, far=cfg.far, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    gts = [torch.rand((H, W, 3), generator=g, device=dev) for _ in cams]
    return model, cfg, cams, gts


@pytest.mark.cuda
def test_graphed_step_is_bit_equal_to_the_eager_step(cuda_device, counters):
    """Nine steps through eager call, capture and replays, with the camera,
    the frame and t changing (on and beside the keyframe boundaries t = 2
    and 7), one step that overflows the capacity (its splats grown in place
    first, so the key stays; the state comes back bit for bit), and the
    state swapped for a copy of itself (a new key, as the trainer's density
    events give: a second eager call and capture). Every tensor of the
    state and every small output equals the eager step's bit for bit; the
    counters show each call's way and one launch of A, B and the pack VJP
    per step."""
    dev = cuda_device
    model, cfg, cams, gts = _card_scene(dev)
    bg = torch.tensor([0.2, 0.4, 0.1], device=dev)
    grow = 1.5  # added to the log scales of the overflowing step's splats

    def totals(m):
        with torch.no_grad():
            return [int(render(c, m, cfg, t=t, bg=bg, capacity=2**22,
                               device=dev).binning_total) for c in cams for t in (0.0, 9.5)]

    ring = max(totals(model))
    grown = {**model.params, "scaling": model.params["scaling"] + grow}
    big = min(totals(model.replace(params=grown)))
    assert big > 2 * ring, (ring, big)  # the grown splats overflow, the others stay below
    statics = S.StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                            capacity=(big + ring) // 2)
    b = np.float32(2.0)
    ts = [1.5, float(b), float(np.nextafter(b, np.float32(-np.inf))), 2.5, 7.0, 6.75,
          float(np.nextafter(np.float32(7.0), np.float32(np.inf))), 9.5, 0.0]
    plan = [(0, 0), (1, 1), (2, 2), (3, 3), (3, 4), (0, 5), (1, 6), (2, 7), (3, 8)]
    overflow_at, swap_at = 3, 5  # plan index: grown splats; a copy of the state
    it = 700

    def run(m, st, eager: bool):
        rows = []
        for i, (c, j) in enumerate(plan):
            if i == swap_at:
                m, st = S.clone_state(m, st)
            if eager:
                graphs.release()  # every call is its key's first: eager
            if i == overflow_at:
                scales = m.params["scaling"].clone()
                m.params["scaling"].add_(grow)  # in place: the same key
            before = {k: v.clone() for k, v in _state(m, st).items()}
            out = S.train_step(m, st, cams[c], gts[c], ts[j], bg, it + i, statics, device=dev)
            pack_launches.append(kernels.launches["pack_vjp"])
            for k, v in _state(out.model, out.opt_state).items():
                assert v is _state(m, st)[k], k  # the state is updated in place
            m, st = out.model, out.opt_state
            rows.append(({k: v.clone() for k, v in _state(m, st).items()},
                         {f: getattr(out, f) for f in SMALL}, before))
            if i == overflow_at:
                m.params["scaling"].copy_(scales)
        return rows

    pack_launches = []  # the pack VJP's count after each call
    graphs.release()
    eager = run(*S.clone_state(model, init_state(model.params, device=dev)), eager=True)
    kernels.reset_launches()
    kernels.reset_graph_calls()
    graphed = run(*S.clone_state(model, init_state(model.params, device=dev)), eager=False)
    torch.cuda.synchronize()
    assert kernels.graph_call_counts(dev) == {"eager": 2, "captures": 2, "replays": 7}
    n = len(plan)
    assert kernels.launches["composite_fwd"] == n and kernels.launches["composite_bwd"] == n
    # one pack VJP a call, in the eager calls, the captures and the replays
    assert pack_launches[-n:] == list(range(1, n + 1)), pack_launches
    for i, ((ws, wo, _), (gs, go, gb)) in enumerate(zip(eager, graphed)):
        for k in ws:
            assert _same_bits(gs[k], ws[k]), (i, k)
        for f in SMALL:
            assert _same_bits(go[f], wo[f]), (i, f)
        overflowed = int(go["binning_total"]) > statics.capacity
        assert overflowed == (i == overflow_at), (i, int(go["binning_total"]))
        if overflowed:
            for k in gs:
                assert _same_bits(gs[k], gb[k]), k  # a no-op, bit for bit
        assert not bool(go["nan_flag"]) and math.isfinite(float(go["loss"]))
    # the small outputs are new tensors each call: the first is as it was
    assert _same_bits(graphed[1][1]["loss"], eager[1][1]["loss"])
    graphs.release()


@pytest.mark.cuda
def test_profiler_records_the_kernels_of_a_replay(cuda_device):
    """torch.profiler sees the kernels a replayed graph runs, each with its
    own device time (the benchmark's busy time and kernel seconds read
    them), kernels A and B included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = cuda_device
    model, cfg, cams, gts = _card_scene(dev)
    statics = S.StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                            capacity=2**21)
    m, st = S.clone_state(model, init_state(model.params, device=dev))
    bg = torch.zeros(3, device=dev)
    graphs.release()
    for i in range(2):  # eager, capture
        S.train_step(m, st, cams[0], gts[0], 2.5, bg, 700 + i, statics, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        S.train_step(m, st, cams[1], gts[1], 3.5, bg, 702, statics, device=dev)
        torch.cuda.synchronize()
    kernels_seen = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)]
    names = " ".join(e.name for e in kernels_seen)
    assert "composite_fwd_kernel" in names and "composite_bwd_kernel" in names
    assert len(kernels_seen) > 500, len(kernels_seen)
    assert sum(e.time_range.end - e.time_range.start for e in kernels_seen) > 0
    graphs.release()


_FRAME = ("render", "depth", "opticalflow", "acc", "dominent_idxs", "radii",
          "visibility_filter", "binning_total")


@pytest.mark.cuda
@pytest.mark.parametrize("track_idx", [False, True])
def test_graphed_render_is_bit_equal_to_the_eager_render(cuda_device, counters, track_idx):
    """A path of (camera, t) rendered under no_grad, t crossing the
    keyframe boundaries t = 2 and 7, gives every frame bit for bit as the
    same render with grad enabled (which stays eager); the render's graph
    runs one eager call, one capture and replays for the rest, and the
    step's counter does not move. A new capacity, then a new camera size,
    each re-capture."""
    dev = cuda_device
    model, cfg, cams, _gts = _card_scene(dev)
    bg = torch.tensor([0.2, 0.4, 0.1], device=dev)
    cap = default_capacity(model.static_capacity + model.dynamic_capacity, cams[0].width,
                           cams[0].height)
    b = np.float32(2.0)
    path = [(0, 1.5), (1, float(b)), (2, float(np.nextafter(b, np.float32(-np.inf)))),
            (3, 2.5), (0, 7.0), (1, 6.75), (2, float(np.nextafter(np.float32(7.0),
                                                                np.float32(np.inf)))),
            (3, 9.5), (0, 0.0)]
    small = ring_cameras(2, 3.0, 96, 64, far=cfg.far, device=dev)
    calls = ([(cams[c], t, cap) for c, t in path]
             + [(cams[0], 3.0, 2 * cap), (cams[1], 4.0, 2 * cap)]  # a new capacity
             + [(small[0], 5.0, 2 * cap), (small[1], 8.0, 2 * cap), (small[0], 1.0, 2 * cap)])

    def frame(cam, t, capacity):
        res = render(cam, model, cfg, t=t, bg=bg, capacity=capacity, track_idx=track_idx,
                     device=dev)
        return {f: getattr(res, f).detach().clone() for f in _FRAME}

    graphs.release()
    want = [frame(*c) for c in calls]  # grad enabled: eager
    assert kernels.graph_call_counts(dev, "render") == {"eager": 0, "captures": 0, "replays": 0}
    with torch.no_grad():
        got = [frame(*c) for c in calls]
    torch.cuda.synchronize()
    n = len(path)
    # each key: its eager call, its capture (which replays too), replays
    assert kernels.graph_call_counts(dev, "render") == {"eager": 3, "captures": 3,
                                                         "replays": (n - 1) + 1 + 2}
    assert kernels.graph_call_counts(dev) == {"eager": 0, "captures": 0, "replays": 0}
    for i, (w, g) in enumerate(zip(want, got)):
        for f in _FRAME:
            assert _same_bits(g[f], w[f]), (i, f)
    assert len({int(g["binning_total"]) for g in got[:n]}) > 1  # the frames differ
    graphs.release()


@pytest.mark.cuda
def test_render_in_a_step_stays_eager_and_a_new_step_key_releases_it(cuda_device, counters):
    """A render with grad enabled, and the renders inside train_step's
    eager call, capture and replays, leave the render's counter where it
    was; a train_step with a new key releases the card's render graph, and
    a no-gradient render between replayed steps does not evict the step's
    graph."""
    dev = graphs.card(cuda_device)
    model, cfg, cams, gts = _card_scene(dev)
    statics = S.StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                            capacity=2**21)
    bg = torch.zeros(3, device=dev)
    graphs.release()
    render(cams[0], model, cfg, t=2.5, bg=bg, capacity=statics.capacity, device=dev)
    assert kernels.graph_call_counts(dev, "render")["eager"] == 0
    with torch.no_grad():
        for c in cams[:2]:  # eager, capture
            render(c, model, cfg, t=2.5, bg=bg, capacity=statics.capacity, device=dev)
    assert ("render", dev) in graphs._GRAPHS
    m, st = S.clone_state(model, init_state(model.params, device=dev))
    S.train_step(m, st, cams[0], gts[0], 2.5, bg, 700, statics, device=dev)  # a new key
    assert ("render", dev) not in graphs._GRAPHS
    for i in range(1, 4):  # capture, replay, replay, each with a viewer frame between
        S.train_step(m, st, cams[i], gts[i], 2.5 + i, bg, 700 + i, statics, device=dev)
        with torch.no_grad():
            render(cams[i], model, cfg, t=1.0, bg=bg, capacity=statics.capacity, device=dev)
    torch.cuda.synchronize()
    assert kernels.graph_call_counts(dev) == {"eager": 1, "captures": 1, "replays": 3}
    assert kernels.graph_call_counts(dev, "render") == {"eager": 2, "captures": 2,
                                                         "replays": 3}
    graphs.release()
