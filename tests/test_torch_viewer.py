"""ex4dgs_tpu_torch's live viewer (`viewer.py`) and the trainer paths that
serve it, against the JAX package's.

The two cases of tests/test_viewer.py on the port (a loopback round trip of
the SIBR wire protocol; a Trainer serving a request mid-training), plus:
- a wire message gives the port's RenderCamera exactly the JAX `receive`'s
  view, proj, campos and tan-fov;
- a reply is the render of the request's camera with track_idx=False,
  converted as `send` converts it, byte for byte; a 0-resolution
  keep-alive renders nothing;
- the training CLI's --port serves the viewer, and --debug with a forced
  NaN writes an npz with the JAX trainer's keys.
"""
import json
import math
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from ex4dgs_tpu.data.readers import read_n3v_scene as jread_n3v_scene
from ex4dgs_tpu.data.scene import Scene as JScene
from ex4dgs_tpu.models import ModelConfig as JModelConfig
from ex4dgs_tpu.models import OptimizationConfig as JOptimizationConfig
from ex4dgs_tpu.train.trainer import Trainer as JTrainer
from ex4dgs_tpu.viewer import NetworkViewer as JNetworkViewer
from ex4dgs_tpu_torch import synthetic
from ex4dgs_tpu_torch.data.readers import read_n3v_scene
from ex4dgs_tpu_torch.data.scene import Scene
from ex4dgs_tpu_torch.models.config import ModelConfig, OptimizationConfig
from ex4dgs_tpu_torch.ops.math3d import projection_matrix, world_to_view
from ex4dgs_tpu_torch.rendering import render
from ex4dgs_tpu_torch.train import __main__ as train_cli
from ex4dgs_tpu_torch.train import trainer as trainer_mod
from ex4dgs_tpu_torch.viewer import NetworkViewer
from test_data_io import _write_colmap_model, _write_frames
from test_viewer import _recv_exact, _send_msg, _wire_message

torch.set_num_threads(2)

W, H = 32, 24
FOV = math.radians(60)


def _camera(t=(0.3, -0.2, 4.0)):
    view = world_to_view(np.eye(3), np.array(t, np.float32))
    proj = (projection_matrix(0.2, 50.0, FOV, FOV) @ view).astype(np.float32)
    return view, proj


def _serve(viewer, render_fn, client, source_path="/data/scene"):
    """Run `client(port)` in a thread while polling the viewer on a
    wall-clock deadline (tests/test_viewer.py's loop); returns what the
    client returned."""
    port = viewer.init()
    result = {}
    th = threading.Thread(target=lambda: result.update(client(port)))
    th.start()
    deadline = time.monotonic() + 60
    while th.is_alive() and time.monotonic() < deadline:
        viewer.poll(render_fn, source_path=source_path, training_active=True)
        time.sleep(0.002)
    th.join(timeout=30)
    viewer.close()
    assert not th.is_alive(), "viewer client thread did not finish"
    return result


def _reply(s, n_bytes):
    img = _recv_exact(s, n_bytes) if n_bytes else None
    return img, _recv_exact(s, int.from_bytes(_recv_exact(s, 4), "little"))


def test_viewer_loopback_roundtrip():
    view, proj = _camera()
    got = {}

    def render_fn(req):
        got["req"] = req
        img = torch.zeros((req.camera.height, req.camera.width, 3))
        img[..., 0] = 1.0  # pure red
        return img

    def client(port):
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.settimeout(60)
        _send_msg(s, _wire_message(view, proj, 0, 0, FOV, FOV, train=False))  # keep-alive
        _, ka_verify = _reply(s, 0)
        _send_msg(s, _wire_message(view, proj, W, H, FOV, FOV, train=True))
        img, verify = _reply(s, H * W * 3)
        s.close()
        return {"ka_verify": ka_verify, "img": img, "verify": verify}

    out = _serve(NetworkViewer(port=0, device="cpu"), render_fn, client)
    assert out["ka_verify"] == out["verify"] == b"/data/scene"
    img = np.frombuffer(out["img"], np.uint8).reshape(H, W, 3)
    assert (img[..., 0] == 255).all() and (img[..., 1:] == 0).all()
    req = got["req"]
    assert req.camera.width == W and req.camera.height == H and req.timestamp == 2.5
    assert req.camera.view.device.type == "cpu"
    np.testing.assert_allclose(req.camera.view.numpy(), view, atol=1e-5)
    np.testing.assert_allclose(req.camera.proj.numpy(), proj, atol=1e-5)
    np.testing.assert_allclose(req.camera.campos.numpy(), np.linalg.inv(view)[:3, 3],
                               atol=1e-5)


@pytest.mark.parametrize("eye", [(0.3, -0.2, 4.0), (-1.7, 0.9, 2.5)])
def test_wire_message_gives_jax_camera_exactly(eye):
    """The same bytes through both packages' `receive` (a socket pair in
    place of the listener): the same float32 view, proj, campos and
    tan-fov, and the same flags."""
    view, proj = _camera(eye)
    reqs = {}
    for name, viewer in (("jax", JNetworkViewer(port=0)),
                         ("port", NetworkViewer(port=0, device="cpu"))):
        a, b = socket.socketpair()
        viewer.conn = a
        _send_msg(b, _wire_message(view, proj, W, H, FOV, 0.8 * FOV, train=False, t=1.25))
        reqs[name] = viewer.receive()
        a.close()
        b.close()
        viewer.close()
    j, p = reqs["jax"], reqs["port"]
    for f in ("view", "proj", "campos", "tan_fovx", "tan_fovy"):
        want = np.asarray(getattr(j.camera, f))
        got = getattr(p.camera, f).numpy()
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want), f
    assert (p.camera.width, p.camera.height) == (j.camera.width, j.camera.height)
    assert p._replace(camera=None) == j._replace(camera=None)


def test_reply_is_the_render_of_the_request_byte_for_byte():
    model, cfg = synthetic.make_scene(n_static=400, n_dynamic=40, seed=2, device="cpu")
    cam = synthetic.ring_cameras(1, 3.0, 40, 30, far=cfg.far, device="cpu")[0]
    view, proj = cam.view.numpy(), cam.proj.numpy()
    fov = 2 * math.atan(float(cam.tan_fovx))
    bg = torch.zeros(3)
    served = []

    def render_fn(req):
        served.append(req)
        return render(req.camera, model, cfg, t=req.timestamp, bg=bg, capacity=65536,
                      scaling_modifier=req.scaling_modifier, track_idx=False,
                      device="cpu").render

    def client(port):
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.settimeout(60)
        replies = []
        for t in (0.0, 2.5, 7.0):
            _send_msg(s, _wire_message(view, proj, 40, 30, fov, fov, train=False, t=t))
            replies.append(_reply(s, 40 * 30 * 3))
        _send_msg(s, _wire_message(view, proj, 0, 0, fov, fov, train=True))
        replies.append(_reply(s, 0))
        s.close()
        return {"replies": replies}

    out = _serve(NetworkViewer(port=0, device="cpu"), render_fn, client)
    replies = out["replies"]
    assert len(served) == 3 and replies[-1] == (None, b"/data/scene")  # keep-alive: no render
    for req, (img, verify) in zip(served, replies):
        want = render(req.camera, model, cfg, t=req.timestamp, bg=bg, capacity=65536,
                      track_idx=False, device="cpu").render
        assert verify == b"/data/scene"
        assert img == NetworkViewer.to_bytes(want)
        assert img == (np.clip(want.numpy(), 0, 1) * 255).astype(np.uint8).tobytes()
    assert replies[0][0] != replies[2][0]  # the timestamp reached the render


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    """tests/test_viewer.py's on-disk scene."""
    root = str(tmp_path_factory.mktemp("vscene"))
    _write_colmap_model(os.path.join(root, "colmap_0", "sparse", "0"), n_cams=3, n_pts=120)
    _write_frames(root, n_cams=3, n_frames=2)
    return root


SCENE = dict(loader="neural3dvideo", resolution=8, duration=-1, time_interval=2, time_pad=1,
             start_duration=2, near=0.05, far=50.0)
SCHEDULE = dict(iterations=3, densify_from_iter=1000, extract_from_iter=1000,
                densify_until_iter=0, prune_invisible_interval=100000,
                random_background=False)


def _wire_client(port, result, t=(0.0, 0.0, 4.0)):
    view, proj = _camera(t)
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    s.settimeout(60)
    _send_msg(s, _wire_message(view, proj, W, H, FOV, FOV, train=True))
    result["img"], result["verify"] = _reply(s, H * W * 3)
    s.close()


def test_trainer_serves_viewer_mid_training(scene_root):
    """The Trainer polls the gui before every step and serves a live render
    of the current model."""
    cfg = ModelConfig(source_path=scene_root, **SCENE)
    scene = Scene(cfg, scene_info=read_n3v_scene(scene_root, cfg))
    viewer = NetworkViewer(port=0, device="cpu")
    port = viewer.init()
    trainer = trainer_mod.Trainer(cfg, OptimizationConfig(**SCHEDULE), scene, capacity=65536,
                                  gui=viewer, device="cpu")
    result = {}
    th = threading.Thread(target=_wire_client, args=(port, result))
    th.start()
    trainer.train(iterations=3)
    th.join(timeout=30)
    trainer.close()
    viewer.close()
    assert not th.is_alive(), "viewer client not served during training"
    assert result["verify"] == scene_root.encode()
    assert np.frombuffer(result["img"], np.uint8).shape == (H * W * 3,)
    assert trainer.gui_renders == 1 and trainer.steps == 3


SCENE_ARGS = ["--loader", "neural3dvideo", "--resolution", "8", "--time_interval", "2",
              "--time_pad", "1", "--start_duration", "2", "--near", "0.05", "--far", "50.0",
              "--densify_from_iter", "1000", "--extract_from_iter", "1000",
              "--densify_until_iter", "0", "--prune_invisible_interval", "100000",
              "--random_background", "false", "--quiet", "--device", "cpu"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_serves_the_viewer(scene_root, tmp_path):
    """--port starts the viewer and the trainer serves it; the report
    counts the served render."""
    port = _free_port()
    result = {}

    def client():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                return _wire_client(port, result)
            except ConnectionRefusedError:  # the CLI has not bound yet
                time.sleep(0.01)

    th = threading.Thread(target=client)
    th.start()
    out = str(tmp_path / "out")
    assert train_cli.main(["--source_path", scene_root, "--model_path", out, "--iterations",
                           "40", "--port", str(port), *SCENE_ARGS]) == 0
    th.join(timeout=30)
    assert not th.is_alive() and result["verify"] == scene_root.encode()
    with open(os.path.join(out, "train_report.json")) as f:
        report = json.load(f)
    assert report["gui_renders"] == 1


def test_debug_snapshot_has_jax_keys(scene_root, tmp_path, monkeypatch):
    """--debug with a forced NaN flag at iteration 2, in the pipelined loop
    (the default): the flag is read when step 2 is finalized, during
    iteration 3, and the snapshot is named by the trainer's iteration then,
    as the JAX trainer names it: debug/nan_snapshot_3.npz, with the keys,
    shapes and dtypes of the JAX trainer's snapshot of the same scene."""
    step = trainer_mod.train_step

    def nan_at_2(model, opt_state, cam, gt, timestamp, bg, it, statics, **kw):
        out = step(model, opt_state, cam, gt, timestamp, bg, it, statics, **kw)
        return out._replace(nan_flag=torch.tensor(it == 2))

    monkeypatch.setattr(trainer_mod, "train_step", nan_at_2)
    monkeypatch.delenv("EX4DGS_PIPELINE", raising=False)
    out = str(tmp_path / "out")
    assert train_cli.main(["--source_path", scene_root, "--model_path", out, "--iterations",
                           "3", "--debug", *SCENE_ARGS]) == 0
    assert os.listdir(os.path.join(out, "debug")) == ["nan_snapshot_3.npz"]
    got = np.load(os.path.join(out, "debug", "nan_snapshot_3.npz"))
    with open(os.path.join(out, "train_report.json")) as f:
        assert json.load(f)["event_counts"]["prune_nan"] == 1

    jcfg = JModelConfig(source_path=scene_root, **SCENE)
    jtr = JTrainer(jcfg, JOptimizationConfig(**SCHEDULE),
                   JScene(jcfg, scene_info=jread_n3v_scene(scene_root, jcfg)), capacity=65536,
                   debug_snapshot_dir=str(tmp_path / "jax_debug"))
    jtr.last_cam = jtr.scene.train_cameras[0]
    jtr.iteration = 3
    jtr._dump_debug_snapshot()
    want = np.load(tmp_path / "jax_debug" / "nan_snapshot_3.npz")
    assert sorted(got.files) == sorted(want.files)
    assert {"iteration", "cam_view", "cam_proj", "cam_timestamp"} <= set(got.files)
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert int(got["iteration"]) == 3


def test_debug_snapshot_serial_names_the_step(scene_root, tmp_path, monkeypatch):
    """The serial loop (EX4DGS_PIPELINE=0) reads the NaN flag in the
    iteration that raised it: debug/nan_snapshot_2.npz, one prune_nan."""
    step = trainer_mod.train_step

    def nan_at_2(model, opt_state, cam, gt, timestamp, bg, it, statics, **kw):
        out = step(model, opt_state, cam, gt, timestamp, bg, it, statics, **kw)
        return out._replace(nan_flag=torch.tensor(it == 2))

    monkeypatch.setattr(trainer_mod, "train_step", nan_at_2)
    monkeypatch.setenv("EX4DGS_PIPELINE", "0")
    out = str(tmp_path / "out")
    assert train_cli.main(["--source_path", scene_root, "--model_path", out, "--iterations",
                           "3", "--debug", *SCENE_ARGS]) == 0
    assert os.listdir(os.path.join(out, "debug")) == ["nan_snapshot_2.npz"]
    assert int(np.load(os.path.join(out, "debug", "nan_snapshot_2.npz"))["iteration"]) == 2
    with open(os.path.join(out, "train_report.json")) as f:
        report = json.load(f)
    assert report["event_counts"]["prune_nan"] == 1 and report["pipeline"] is False
