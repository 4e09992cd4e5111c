"""ex4dgs_tpu_torch's data layer and model IO against the JAX package's.

The cases of tests/test_data_io.py, on the scenes its writers make
(`_write_colmap_model`, `_write_frames`), each read or written by both
packages:

- COLMAP models (binary and text), the N3V, Technicolor and COLMAP readers,
  `Scene` and its cameras (down to each camera's RenderCamera arrays): the
  same cameras, points and images as the JAX package's;
- PLYs and checkpoints written by either package load into the other, array
  for array; the model PLYs are byte-equal; a checkpoint goes JAX -> port
  -> JAX and port -> JAX -> port unchanged, including its kernel config;
- the port's prefetcher decodes what the JAX package's `load_image` (its
  PIL path) decodes, and its GT cache holds tensors on the device (here the
  CPU) with the JAX package's LRU-by-bytes rule.
"""
import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from ex4dgs_tpu.data import colmap as jcolmap
from ex4dgs_tpu.data import readers as jreaders
from ex4dgs_tpu.data.scene import Scene as JScene
from ex4dgs_tpu.data.scene import load_image as jload_image
from ex4dgs_tpu.io import checkpoint as jckpt
from ex4dgs_tpu.io import model_ply as jmply
from ex4dgs_tpu.io import ply as jply
from ex4dgs_tpu.kernel_config import KernelConfig as JKernelConfig
from ex4dgs_tpu.models import ModelConfig as JModelConfig
from ex4dgs_tpu.models import create_from_pcd as jcreate
from ex4dgs_tpu.models import density as JD
from ex4dgs_tpu.models.optimizer import init_state as jinit
from ex4dgs_tpu_torch.data import colmap
from ex4dgs_tpu_torch.data import readers
from ex4dgs_tpu_torch.data.cameras import Camera, resolve_resolution
from ex4dgs_tpu_torch.data.scene import ImagePrefetcher, Scene, load_image
from ex4dgs_tpu_torch.io import checkpoint, model_ply, ply
from ex4dgs_tpu_torch.kernel_config import KernelConfig
from ex4dgs_tpu_torch.models import density as D
from ex4dgs_tpu_torch.models.config import ModelConfig
from test_data_io import _write_colmap_model, _write_frames
from torch_parity import as_jax_host as _as_jax
from torch_parity import assert_hosts_equal as _assert_same
from torch_parity import port_pull as _port_pull

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _n3v(tmp_path, n_cams=3, n_frames=4):
    root = str(tmp_path / "scene")
    _write_colmap_model(os.path.join(root, "colmap_0", "sparse", "0"), n_cams=n_cams)
    _write_frames(root, n_cams=n_cams, n_frames=n_frames)
    return root


def _cameras_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            if f.name.startswith("_"):
                continue
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, (f.name, a, b)


def _infos_equal(got, want):
    np.testing.assert_array_equal(got.point_cloud.points, want.point_cloud.points)
    np.testing.assert_array_equal(got.point_cloud.colors, want.point_cloud.colors)
    _cameras_equal(got.train_cameras, want.train_cameras)
    _cameras_equal(got.test_cameras, want.test_cameras)
    assert got.ply_path == want.ply_path
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_colmap_roundtrip(tmp_path, fmt):
    sparse = str(tmp_path / "sparse" / "0")
    _write_colmap_model(sparse)
    if fmt == "txt":  # the same model as COLMAP text files
        cams, imgs = jcolmap.read_model(sparse)
        xyz, rgb, err = jcolmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            for c in cams.values():
                f.write(f"{c.id} {c.model} {c.width} {c.height} "
                        + " ".join(repr(float(p)) for p in c.params) + "\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# a comment line\n")
            for im in imgs.values():
                f.write(f"{im.id} " + " ".join(repr(float(v)) for v in (*im.qvec, *im.tvec))
                        + f" {im.camera_id} {im.name}\n\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            for i, (p, c, e) in enumerate(zip(xyz, rgb, err)):
                f.write(f"{i} " + " ".join(repr(float(v)) for v in p)
                        + " " + " ".join(str(int(v)) for v in c) + f" {float(e[0])!r}\n")
        for name in ("cameras.bin", "images.bin"):
            os.remove(os.path.join(sparse, name))
    cams, imgs = colmap.read_model(sparse)
    jcams, jimgs = jcolmap.read_model(sparse)
    assert len(cams) == 3 and len(imgs) == 3 and cams[1].model == "PINHOLE"
    assert imgs[1].name == "cam00.png"
    for a, b in [*zip(cams.values(), jcams.values()), *zip(imgs.values(), jimgs.values())]:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    read = {"bin": "read_points3d_binary", "txt": "read_points3d_text"}[fmt]
    path = os.path.join(sparse, f"points3D.{fmt}")
    for x, y in zip(getattr(colmap, read)(path), getattr(jcolmap, read)(path)):
        np.testing.assert_array_equal(x, y)
    xyz, rgb, _ = getattr(colmap, read)(path)
    assert xyz.shape == (50, 3) and rgb[0, 0] == 100


def test_n3v_reader_and_scene(tmp_path):
    root = _n3v(tmp_path)
    kw = dict(source_path=root, loader="neural3dvideo", resolution=2, duration=-1,
              time_interval=2, time_pad=1)
    cfg, jcfg = ModelConfig(**kw), JModelConfig(**kw)
    info = readers.read_n3v_scene(root, cfg)
    _infos_equal(info, jreaders.read_n3v_scene(root, jcfg))
    assert all("cam00" in c.image_path for c in info.test_cameras)
    assert len(info.test_cameras) == 4 and len(info.train_cameras) == 8

    scene, jscene = Scene(cfg, scene_info=info), JScene(jcfg, scene_info=info)
    assert scene.duration == jscene.duration == 4
    assert scene.cameras_extent == jscene.cameras_extent
    _cameras_equal(scene.train_cameras, jscene.train_cameras)
    _cameras_equal(scene.test_cameras, jscene.test_cameras)
    assert scene.train_cameras[0].width == 320
    for cam, jcam in zip(scene.train_cameras[:2], jscene.train_cameras[:2]):
        rc, jrc = cam.render_camera("cpu"), jcam.render_camera()
        for k in ("view", "proj", "campos", "tan_fovx", "tan_fovy"):
            np.testing.assert_array_equal(getattr(rc, k).numpy(), np.asarray(getattr(jrc, k)), k)
        assert (rc.width, rc.height) == (jrc.width, jrc.height)
        assert cam.render_camera("cpu") is rc  # built once per device
    for s in (scene, jscene):
        s.set_sampling_len(1.0)
    _cameras_equal(scene.sampled_train_cameras(), jscene.sampled_train_cameras())
    assert all(c.timestamp <= 1.0 for c in scene.sampled_train_cameras())

    # PIL, the decoder of JAX's load_image (the native pool's parity with
    # JAX's is tests/test_torch_native.py's)
    pf = ImagePrefetcher(workers=2, lookahead=2, native=False, device="cpu")
    seen = 0
    for cam, img in pf.epoch(scene.sampled_train_cameras(), shuffle=True):
        assert img.shape == (cam.height, cam.width, 3) and img.dtype == torch.float32
        want = jload_image(cam.image_path, (cam.width, cam.height), cam.im_scale)
        np.testing.assert_array_equal(img.numpy(), want)
        seen += 1
    pf.close()
    assert seen == len(scene.sampled_train_cameras())

    for pad_type in (1, 2):  # reflect, repeat
        s, js = Scene(cfg, scene_info=info), JScene(jcfg, scene_info=info)
        n0 = len(s.train_cameras)
        s.apply_timepad(1, pad_type)
        js.apply_timepad(1, pad_type)
        assert len(s.train_cameras) > n0
        _cameras_equal(s.train_cameras, js.train_cameras)


@pytest.mark.parametrize("loader", ["technicolor", "colmap"])
def test_technicolor_and_colmap_readers(tmp_path, loader):
    """The other two readers on the same model: Technicolor's flat
    `<Scene>_undist_<t>_<cam>.png` frames (translations and points divided
    by the scene radius) and a static COLMAP scene's images/ with the
    llffhold split."""
    from PIL import Image

    root = str(tmp_path / "scene")
    sparse = (os.path.join(root, "colmap_0", "sparse", "0") if loader == "technicolor"
              else os.path.join(root, "sparse", "0"))
    _write_colmap_model(sparse, n_cams=4)
    for c in range(4):
        arr = np.full((48, 64, 3), 30 * c, np.uint8)
        if loader == "technicolor":
            for t in range(3):
                Image.fromarray(arr + 10 * t).save(
                    os.path.join(root, f"Birthday_undist_{t:05d}_{c:02d}.png"))
        else:
            os.makedirs(os.path.join(root, "images"), exist_ok=True)
            Image.fromarray(arr).save(os.path.join(root, "images", f"cam{c:02d}.png"))
    kw = dict(source_path=root, loader=loader, eval=loader == "colmap", llffhold=2)
    read = readers.SCENE_READERS[loader]
    assert read.__name__ == jreaders.SCENE_READERS[loader].__name__
    info = read(root, ModelConfig(**kw))
    _infos_equal(info, jreaders.SCENE_READERS[loader](root, JModelConfig(**kw)))
    assert len(info.train_cameras) == (12 if loader == "technicolor" else 2)


CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.json"))


@pytest.mark.parametrize("path", CONFIGS)
def test_load_configs_match_jax(path):
    """Every config of the repo overlays onto the port's model and
    optimization configs as onto the JAX package's, field for field."""
    from ex4dgs_tpu.models.config import load_configs as jload_configs
    from ex4dgs_tpu_torch.models.config import load_configs

    got, want = load_configs(str(ROOT / path)), jload_configs(str(ROOT / path))
    assert len(got) == 2
    for g, w in zip(got, want[:2]):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert type(g).__name__ == type(w).__name__
    assert got[0].resolution != -1  # the JSON overlaid


def test_resolve_resolution():
    assert resolve_resolution(2704, 2028, 2) == (1352, 1014)
    assert resolve_resolution(2704, 2028, -1) == (1600, 1200)
    assert resolve_resolution(1024, 768, -1) == (1024, 768)


def test_basic_ply_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(20, 3)).astype(np.float32)
    rgb = rng.uniform(size=(20, 3)).astype(np.float32)
    p, jp = str(tmp_path / "pc.ply"), str(tmp_path / "jpc.ply")
    ply.write_basic_ply(p, xyz, rgb)
    jply.write_basic_ply(jp, xyz, rgb)
    assert open(p, "rb").read() == open(jp, "rb").read()
    pts, cols = ply.read_basic_ply(jp)
    np.testing.assert_allclose(pts, xyz, atol=1e-6)
    np.testing.assert_allclose(cols, rgb, atol=1 / 255)
    for x, y in zip((pts, cols), jply.read_basic_ply(p)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ply.read_ply(p), jply.read_ply(p))


def _hostmodel(n=30, seed=2, capacity=32, dynamics=True):
    """The port's HostModel of a seeded JAX model (with a few extracted
    dynamic splats), checked against the JAX package's pull."""
    rng = np.random.default_rng(seed)
    cfg = JModelConfig(time_interval=5, duration=10)
    jm = jcreate(rng.normal(size=(n, 3)).astype(np.float32),
                 rng.uniform(size=(n, 3)).astype(np.float32), cfg, duration=10.0,
                 static_capacity=capacity)
    hm = _port_pull(jm)
    _assert_same(hm, JD.pull(jm, jinit(jm.params)))
    if dynamics:
        hm.params["xyz_disp"][:4] = 1.5
        hm.stats["xyz_error_min_timestamp"][:] = 1.0
        D.extract_dynamic_from_static(hm, cfg, np.zeros(3, np.float32), 1.0,
                                      np.ones(hm.n_static, bool), extent=3.0, percentile=0.8,
                                      max_dur=10.0)
        assert hm.n_dynamic > 0
    return cfg, hm


def test_model_ply_roundtrip(tmp_path):
    cfg, hm = _hostmodel()
    path, jpath = str(tmp_path / "port" / "point_cloud.ply"), str(tmp_path / "jax" /
                                                                  "point_cloud.ply")
    model_ply.save_model_ply(hm, path)
    jmply.save_model_ply(_as_jax(hm), jpath)
    for name in ("point_cloud.ply", "dynamic_point_cloud.ply"):
        assert (open(str(tmp_path / "port" / name), "rb").read()
                == open(str(tmp_path / "jax" / name), "rb").read()), name

    tcfg = ModelConfig(**vars(cfg))
    hm2 = model_ply.load_model_ply(jpath, tcfg, duration=10.0)
    _assert_same(hm2, jmply.load_model_ply(path, cfg, duration=10.0))
    assert (hm2.n_static, hm2.n_dynamic) == (hm.n_static, hm.n_dynamic)
    for k in ("xyz", "opacity", "scaling", "rotation", "xyz_disp",
              "motion_xyz", "motion_opacity_center", "motion_rotation"):
        np.testing.assert_allclose(hm2.params[k], hm.params[k], atol=1e-6, err_msg=k)


def _trains(model, state, cfg):
    """One port train step from a loaded state: finite, and one more
    optimizer step."""
    import math

    from ex4dgs_tpu_torch.models.config import OptimizationConfig
    from ex4dgs_tpu_torch.synthetic import ring_cameras
    from ex4dgs_tpu_torch.train.step import StepStatics, train_step

    cam = ring_cameras(1, 3.0, 48, 32, far=cfg.far, device="cpu")[0]
    statics = StepStatics(cfg=cfg, opt=OptimizationConfig(), spatial_lr_scale=1.0,
                          capacity=8192)
    out = train_step(model, state, cam, torch.full((32, 48, 3), 0.5), 1.0, torch.zeros(3), 18,
                     statics, device="cpu")
    assert math.isfinite(float(out.loss)) and int(out.opt_state.step) == int(state.step) + 1
    assert all(bool(torch.isfinite(v).all()) for v in out.model.params.values())


def test_checkpoint_roundtrip(tmp_path):
    """A checkpoint of either package loads into the other array for
    array: JAX -> port (which trains from it) -> JAX and port -> JAX ->
    port, with the JAX trainer's kernel-config record read by the port's
    KernelConfig."""
    cfg, hm = _hostmodel()
    hm.mu["xyz"][:] = 0.5
    hm.nu["motion_xyz"][:] = 0.25
    hm.step = 17
    jkc = JKernelConfig(tile_x=16, tile_y=16, pair=2, exact_sort=True).validate()

    # JAX -> port -> JAX
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, _as_jax(hm), 1234,
                          extra={"sample_len": 7.0, "kernel_config": jkc.to_json()})
    got, it, extra = checkpoint.load_checkpoint(jpath)
    assert it == 1234 and float(extra["sample_len"]) == 7.0
    _assert_same(got, _as_jax(hm))
    kc = KernelConfig.from_dict(json.loads(str(extra["kernel_config"])))
    assert kc == KernelConfig(tile_x=16, tile_y=16, exact_sort=True)
    model, state = D.push(got, ModelConfig(**vars(cfg)), device="cpu")
    assert int(model.n_static()) == hm.n_static and int(model.n_dynamic()) == hm.n_dynamic
    _trains(model, state, ModelConfig(**vars(cfg)))
    ppath = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(ppath, D.pull(model, state), it,
                               extra={"sample_len": 7.0, "kernel_config": kc.to_json()})
    back, it2, extra2 = jckpt.load_checkpoint(ppath)
    assert it2 == 1234
    _assert_same(hm, back)
    assert JKernelConfig.from_dict({**jkc.as_dict(), **json.loads(str(extra2["kernel_config"]))}
                                   ) == jkc

    # port -> JAX -> port
    ppath2 = str(tmp_path / "port2.npz")
    checkpoint.save_checkpoint(ppath2, hm, 55, extra={"sample_len": 3.0})
    jhm, _, _ = jckpt.load_checkpoint(ppath2)
    jm, js = JD.push(jhm, cfg)
    jpath2 = str(tmp_path / "jax2.npz")
    jckpt.save_checkpoint(jpath2, JD.pull(jm, js), 55, extra={"sample_len": 3.0})
    again, it3, extra3 = checkpoint.load_checkpoint(jpath2)
    assert it3 == 55 and float(extra3["sample_len"]) == 3.0
    _assert_same(again, _as_jax(hm))


def test_prefetcher_device_cache(tmp_path):
    """The GT cache: the second epoch is all hits served from tensors on the
    device, equal to the JAX package's decode; the LRU byte budget evicts
    the oldest frames; with no budget every frame is decoded and uploaded,
    still as a tensor on the device."""
    from PIL import Image

    rng = np.random.default_rng(0)
    cams = []
    for i in range(4):
        arr = rng.integers(0, 255, size=(12, 16, 3)).astype(np.uint8)
        p = str(tmp_path / f"f{i}.png")
        Image.fromarray(arr).save(p)
        cams.append(Camera(colmap_id=i, uid=i, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=1.0,
                           image_name=f"f{i}.png", image_path=p, width=16, height=12,
                           near=0.1, far=10.0, timestamp=float(i)))
    frame_bytes = 12 * 16 * 3 * 4

    # PIL throughout, the decoder the frames are compared with
    pf = ImagePrefetcher(workers=1, lookahead=2, native=False, device_cache_mb=1.0,
                         device="cpu")
    first = {c.colmap_id: img for c, img in pf.epoch(cams, shuffle=False)}
    assert len(pf._cache) == 4 and pf.decodes == 4 and pf.hits == 0
    assert pf.cache_bytes == 4 * frame_bytes
    for cam, img in pf.epoch(cams, shuffle=False):
        assert ("cached", pf._cache_key(cam)) == pf._submit(cam)
        assert img is first[cam.colmap_id]  # the pinned tensor itself
        np.testing.assert_array_equal(img.numpy(), jload_image(cam.image_path, (16, 12)))
        np.testing.assert_array_equal(img.numpy(), load_image(cam.image_path, (16, 12)))
    assert pf.hits == 4 and pf.decodes == 4
    pf.close()

    tiny = ImagePrefetcher(workers=1, lookahead=2, native=False,
                           device_cache_mb=frame_bytes * 2.5 / 2**20, device="cpu")
    for _ in tiny.epoch(cams, shuffle=False):
        pass
    assert len(tiny._cache) == 2 and tiny.cache_bytes <= tiny._cache_budget
    # tickets that outlive their entry degrade to a decode
    for _ in tiny.epoch(cams[2:] + cams[:2], shuffle=False):
        pass
    assert tiny.hits == 2 and tiny.decodes == 6
    tiny.close()

    off = ImagePrefetcher(workers=1, lookahead=2, native=False, device_cache_mb=0,
                          device="cpu")
    for cam, img in off.epoch(cams, shuffle=False):
        assert torch.is_tensor(img) and img.device.type == "cpu"
        np.testing.assert_array_equal(img.numpy(), jload_image(cam.image_path, (16, 12)))
    assert len(off._cache) == 0 and off.decodes == 4
    off.close()


def test_write_n3v_scene_views_disagree(tmp_path):
    """bench_frame.write_n3v_scene(views_agree=False) keeps the model and the
    first camera's first frame, and gives every other camera a texture of
    its own and every camera a faster drift."""
    from PIL import Image

    from ex4dgs_tpu_torch.bench_frame import write_n3v_scene

    kw = dict(n_cams=3, n_frames=2, n_points=50, width=100, height=48, seed=2)
    a = write_n3v_scene(str(tmp_path / "agree"), **kw)
    b = write_n3v_scene(str(tmp_path / "disagree"), views_agree=False, **kw)

    def frame(root, cam, t):
        return np.asarray(Image.open(os.path.join(root, f"cam{cam:02d}", f"{t:04d}.png")))

    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        path = os.path.join("colmap_0", "sparse", "0", name)
        with open(os.path.join(a, path), "rb") as fa, open(os.path.join(b, path), "rb") as fb:
            assert fa.read() == fb.read(), name
    assert np.array_equal(frame(a, 0, 0), frame(b, 0, 0))
    assert not np.array_equal(frame(a, 0, 1), frame(b, 0, 1))  # the drift
    assert not np.array_equal(frame(a, 1, 0), frame(b, 1, 0))  # another texture
    # where two views see the same part of the plane, they agree only in `a`
    shift = 4  # pixels: centres 0.5 apart, focal 0.8 x 100, depth 10
    err = {root: np.abs(frame(root, 0, 0)[:, shift:].astype(int)
                        - frame(root, 1, 0)[:, :-shift].astype(int)).mean() for root in (a, b)}
    assert err[a] < 1 < 10 < err[b], err
