"""ex4dgs_tpu_torch's sharded train step and multi-process start-up against
the JAX package's (tests/test_parallel.py and tests/test_multihost.py on the
port), on the CPU with gloo ranks (tests/test_torch_parallel.py's
`spawn_ranks`).

- At mesh (1, 1) the sharded step is the port's `train_step`, bit for bit.
- At (2, 1), (1, 2) and (2, 2) the same camera on every data rank: loss,
  parameters and `denom` x data within test_sharded_step_matches_single's
  tolerances of the port's `train_step` and of JAX's
  `make_sharded_train_step` on the same mesh (its 8 virtual CPU devices);
  the ranks' models and optimizer states digest-equal.
- Different cameras per data rank at (4, 1), mirroring
  test_different_cameras_per_shard, against JAX's step on the same inputs.
- Two processes joined by `initialize(<file store>, 2, pid)`: one sharded
  step, a checkpoint saved by rank 0 and loaded by both.
- The check `initialize` makes after joining an NCCL job: two ranks on one
  card of one host are refused, ranks on two cards or two hosts are not.

The gradient itself is held too, through the first moment: one step from
init_state leaves mu = 0.1 x the step's gradient. The parameters alone
would not show a gradient off by a constant factor: the first RAdam step
is unrectified (rho_1 < 5), so it moves each parameter by lr x gradient,
which stays below the parameter tolerance at any small factor. The port's
mu is held to `train_step`'s at tests/test_torch_train.py's moment
tolerance (rtol 1e-5, atol 1e-5 of the array's largest entry).

JAX's render-loss gradients at gauss G are G times the single step's (its
shard_map transposes the all-gather of the replicated frame into a sum
over the ranks); its regularizer gradients are the single step's. The
port's render-loss gradients equal the single step's. So against JAX the
render-loss part of mu is compared: (JAX's mu - 0.1 x the regularizers'
gradient) / G against the port's mu less the same term, at the same
tolerance; and JAX's xyz_gradient_accum / G against the port's.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_parallel_step.py
"""
import math

import numpy as np
import pytest
import torch

from ex4dgs_tpu_torch.io.checkpoint import digest, load_checkpoint, save_checkpoint
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.models.density import pull
from ex4dgs_tpu_torch.models.optimizer import RAdamState, init_state
from ex4dgs_tpu_torch.models.state import model_from_numpy
from ex4dgs_tpu_torch.parallel import make_mesh
from ex4dgs_tpu_torch.parallel.step_dp import make_sharded_train_step, replicate, shard_data
from ex4dgs_tpu_torch.rendering import RenderCamera
from ex4dgs_tpu_torch.train.step import StepStatics, _regularizers, train_step
from test_torch_parallel import spawn_ranks

torch.set_num_threads(2)

W, H = 48, 32
CAPACITY = 4096
ITERATION = 600


def _jax_scene():
    """tests/test_parallel.py's scene and camera (the JAX package's)."""
    from ex4dgs_tpu.models import ModelConfig as JModelConfig
    from ex4dgs_tpu.models import create_from_pcd
    from ex4dgs_tpu.ops.math3d import projection_matrix, world_to_view
    from ex4dgs_tpu.rendering import RenderCamera as JCamera

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(100, 3)).astype(np.float32) * 0.8
    cols = rng.uniform(0.1, 0.9, size=(100, 3)).astype(np.float32)
    cfg = JModelConfig(time_interval=5, start_duration=5, duration=10, near=0.2, far=50.0)
    model = create_from_pcd(pts, cols, cfg, duration=5, static_capacity=128)
    view = world_to_view(np.eye(3), np.array([0, 0, 4.0], np.float32))
    fov = math.radians(60)
    P = projection_matrix(0.2, 50.0, fov, fov)
    cam = JCamera.from_fov(view, P @ view, np.linalg.inv(view)[:3, 3], W, H, fov, fov)
    return cfg, model, cam


PORT_CFG = ModelConfig(time_interval=5, start_duration=5, duration=10, near=0.2, far=50.0)


@pytest.fixture(scope="module")
def scene():
    """The JAX scene and its arrays for the port (numpy, picklable)."""
    from torch_parity import model_arrays

    cfg, model, cam = _jax_scene()
    cam_np = [np.asarray(a) for a in (cam.view, cam.proj, cam.campos)]
    cam_np += [cam.width, cam.height, np.asarray(cam.tan_fovx), np.asarray(cam.tan_fovy)]
    return dict(jax=(cfg, model, cam), port=dict(model=model_arrays(model), cam=cam_np))


def _inputs(n, seed, same):
    """n ground truths [H, W, 3] and timestamps: all the first one's if
    `same`, else each its own (timestamps 0, 1, 2, ...)."""
    rng = np.random.default_rng(seed)
    gts = rng.uniform(size=(n, H, W, 3)).astype(np.float32)
    ts = np.arange(n, dtype=np.float32)
    if same:
        gts[:] = gts[0]
        ts[:] = 1.0
    return gts, ts


def _port(port):
    """The port's model, camera and statics of a scene's numpy arrays."""
    model = model_from_numpy(**port["model"], device="cpu")
    cam = RenderCamera.from_numpy(*port["cam"], device="cpu")
    statics = StepStatics(cfg=PORT_CFG, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                          capacity=CAPACITY)
    return model, cam, statics


def _step_rank(rank, world, data, gauss, port, gts, ts):
    """One rank of the sharded step on its camera; its model as numpy and
    its digest."""
    model, cam, statics = _port(port)
    mesh = make_mesh(world, data=data, gauss=gauss, device="cpu")
    state = replicate(init_state(model.params, device="cpu"), mesh)
    model = replicate(model, mesh)
    step = make_sharded_train_step(statics, mesh, device="cpu")
    gt, t = shard_data(list(gts), mesh), shard_data(list(ts), mesh)
    out = step(model, state, cam, torch.from_numpy(gt), float(t), torch.zeros(3), ITERATION)
    hm = pull(out.model, out.opt_state)
    return dict(params=hm.params, stats=hm.stats, mu=hm.mu, loss=float(out.loss),
                binning_total=int(out.binning_total), nan=bool(out.nan_flag), digest=digest(hm))


def _jax_sharded(scene, data, gauss, gts, ts):
    import jax
    import jax.numpy as jnp

    from ex4dgs_tpu.models.optimizer import init_state as j_init
    from ex4dgs_tpu.parallel.mesh import make_mesh as j_mesh
    from ex4dgs_tpu.parallel.step_dp import make_sharded_train_step as j_step
    from ex4dgs_tpu.train.step import StepStatics as JStatics

    cfg, model, cam = scene["jax"]
    statics = JStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                       capacity=CAPACITY, chunk=64, max_per_tile=256)
    step = j_step(statics, j_mesh(data * gauss, data=data, gauss=gauss))
    cams = jax.tree.map(lambda a: jnp.stack([a] * data), cam)
    out = step(model, j_init(model.params), cams, jnp.asarray(gts), jnp.asarray(ts),
               jnp.zeros(3), jnp.asarray(ITERATION, jnp.int32))
    return dict(loss=float(out.loss), params={k: np.asarray(v) for k, v in
                                              out.model.params.items()},
                stats={k: np.asarray(v) for k, v in out.model.stats.items()},
                mu={k: np.asarray(v) for k, v in out.opt_state.mu.items()})


def _reg_mu(port):
    """0.1 x the regularizers' gradient of the port's model at ITERATION
    (their share of the first step's mu), by name, on the rows and
    keyframes that `pull` keeps."""
    model, _, statics = _port(port)
    params = {k: v.detach().requires_grad_(True) for k, v in model.params.items()}
    reg = _regularizers(params, model, statics.opt, statics.cfg, ITERATION)
    grads = torch.autograd.grad(reg, list(params.values()), allow_unused=True)
    mu = {k: torch.zeros_like(v) if g is None else 0.1 * g
          for (k, v), g in zip(params.items(), grads)}
    return pull(model, RAdamState(mu=mu, nu=mu, step=torch.zeros((), dtype=torch.int32))).mu


def _same_mu(got, want, what):
    """tests/test_torch_train.py's moment tolerance."""
    if got.size == 0:  # no rows of this kind (JAX keeps its keyframe columns)
        assert want.size == 0, what
        return
    atol = 1e-5 * np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _close(a, b, what):
    """test_sharded_step_matches_single's parameter tolerance."""
    if a.size == 0:
        return
    close = np.isclose(a, b, rtol=2e-4, atol=5e-5)
    assert close.mean() > 0.95, (what, close.mean(), np.abs(a - b).max())
    assert np.abs(a - b).max() < 2e-3, what


def test_sharded_step_at_1_1_is_train_step(scene):
    model, cam, statics = _port(scene["port"])
    gts, ts = _inputs(1, 1, same=True)
    state = init_state(model.params, device="cpu")
    args = (model, state, cam, torch.from_numpy(gts[0]), float(ts[0]), torch.zeros(3),
            ITERATION)
    ref = train_step(*args, statics, device="cpu")
    out = make_sharded_train_step(statics, make_mesh(device="cpu"), device="cpu")(*args)
    assert out.loss.item() == ref.loss.item() and not bool(out.nan_flag)
    assert int(out.binning_total) == int(ref.binning_total) <= CAPACITY
    assert digest(pull(out.model, out.opt_state)) == digest(pull(ref.model, ref.opt_state))


@pytest.mark.parametrize("data,gauss", [(2, 1), (1, 2), (2, 2)])
def test_sharded_step_matches_single(scene, data, gauss, tmp_path):
    gts, ts = _inputs(data, 1, same=True)
    outs = spawn_ranks(_step_rank, data * gauss, tmp_path, data, gauss, scene["port"], gts,
                       ts)
    assert len({o["digest"] for o in outs}) == 1  # every rank holds the same model
    out = outs[0]
    assert not out["nan"] and out["binning_total"] <= CAPACITY

    model, cam, statics = _port(scene["port"])
    ref = train_step(model, init_state(model.params, device="cpu"), cam,
                     torch.from_numpy(gts[0]), float(ts[0]), torch.zeros(3), ITERATION,
                     statics, device="cpu")
    ref = pull(ref.model, ref.opt_state)
    want = _jax_sharded(scene, data, gauss, gts, ts)
    np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-4, atol=1e-5)
    n = int(scene["port"]["model"]["static_mask"].sum())
    reg = _reg_mu(scene["port"])
    for k, v in out["params"].items():
        _close(v, ref.params[k], f"{k} vs train_step")
        _close(v, want["params"][k][:v.shape[0]], f"{k} vs JAX")
        mu = out["mu"][k]
        _same_mu(mu, ref.mu[k], f"{k} mu vs train_step")
        if mu.size:
            _same_mu(mu - reg[k], (want["mu"][k][:mu.shape[0]] - reg[k]) / gauss,
                     f"{k} mu vs JAX")
    np.testing.assert_allclose(out["stats"]["xyz_gradient_accum"],
                               want["stats"]["xyz_gradient_accum"][:n] / gauss, rtol=1e-5,
                               atol=1e-5 * np.abs(want["stats"]["xyz_gradient_accum"]).max())
    np.testing.assert_allclose(out["stats"]["denom"], ref.stats["denom"] * data, atol=1e-5)
    np.testing.assert_allclose(out["stats"]["denom"], want["stats"]["denom"][:n], atol=1e-5)


def test_different_cameras_per_shard(scene, tmp_path):
    gts, ts = _inputs(4, 2, same=False)
    outs = spawn_ranks(_step_rank, 4, tmp_path, 4, 1, scene["port"], gts, ts)
    assert len({o["digest"] for o in outs}) == 1
    out = outs[0]
    assert math.isfinite(out["loss"])
    for k, v in out["params"].items():
        assert np.isfinite(v).all(), k
    # four distinct timestamps folded into the error-min bookkeeping
    seen = out["stats"]["xyz_error_min_timestamp"]
    assert len(np.unique(seen[seen >= 0])) >= 2
    want = _jax_sharded(scene, 4, 1, gts, ts)
    np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-4, atol=1e-5)
    for k, v in out["params"].items():
        _close(v, want["params"][k][:v.shape[0]], f"{k} vs JAX")
        _same_mu(out["mu"][k], want["mu"][k][:v.shape[0]], f"{k} mu vs JAX")
    n = seen.shape[0]
    np.testing.assert_array_equal(seen, want["stats"]["xyz_error_min_timestamp"][:n])


def _checkpoint_rank(rank, world, port, path):
    """tests/multihost_worker.py on the port: initialize() joined the job
    (spawn_ranks), one sharded step over a (1, 2) mesh, rank 0 saves the
    checkpoint and every rank loads it."""
    import torch.distributed as dist

    from ex4dgs_tpu_torch.runtime.distributed import (host_consistent_seed, initialize,
                                                      shard_cameras_for_host)

    info = initialize(device="cpu")  # already joined: reports the job
    model, cam, statics = _port(port)
    mesh = make_mesh(world, data=1, gauss=world, device="cpu")
    assert len(shard_cameras_for_host([cam, cam], 2)) == 1
    state = init_state(model.params, device="cpu")
    gt = torch.from_numpy(host_consistent_seed(0).uniform(size=(H, W, 3)).astype(np.float32))
    out = make_sharded_train_step(statics, mesh, device="cpu")(
        model, state, cam, gt, 1.0, torch.zeros(3), ITERATION)
    hm = pull(out.model, out.opt_state)
    if rank == 0:
        save_checkpoint(path, hm, 1)
    dist.barrier()
    hm2, it2, _ = load_checkpoint(path)
    return dict(info=info, loss=float(out.loss), digest=digest(hm), resumed=digest(hm2),
                it=it2)


def test_two_process_initialize_and_checkpoint(scene, tmp_path):
    outs = spawn_ranks(_checkpoint_rank, 2, tmp_path, scene["port"],
                       str(tmp_path / "ckpt.npz"))
    for r, o in enumerate(outs):
        assert o["info"] == {"process_index": r, "process_count": 2, "local_devices": 1,
                             "global_devices": 2, "backend": "gloo"}
        assert o["it"] == 1 and math.isfinite(o["loss"])
        assert o["resumed"] == o["digest"] == outs[0]["digest"]


def _seat_rank(rank, world, hosts, cards):
    """runtime.distributed.refuse_shared_cards on a spawned rank that
    claims card cards[rank] of host hosts[rank]: its message, or None."""
    import socket

    from ex4dgs_tpu_torch.runtime import distributed

    socket.gethostname = lambda: hosts[rank]
    try:
        distributed.refuse_shared_cards(cards[rank])
    except RuntimeError as e:
        return str(e)
    return None


@pytest.mark.parametrize("hosts,cards,refused", [
    (("a", "a"), (0, 0), True),  # two ranks on the one card of a host
    (("a", "a"), (0, 1), False),  # one host, a card each
    (("a", "b"), (0, 0), False),  # two hosts of one card each
], ids=["shared", "two_cards", "two_hosts"])
def test_nccl_ranks_sharing_a_card_are_refused(tmp_path, hosts, cards, refused):
    """The check initialize() makes after joining an NCCL job: every rank
    raises, naming --dist_backend gloo, when two ranks hold one card of one
    host, and only then."""
    msgs = spawn_ranks(_seat_rank, 2, tmp_path, hosts, cards, limit=60)
    if refused:
        for m in msgs:
            assert "2 ranks hold card 0 of host a" in m and "--dist_backend gloo" in m
    else:
        assert msgs == [None, None]
