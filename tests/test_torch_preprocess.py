"""ex4dgs_tpu_torch's dataset preparation (`preprocess/`) and scene
conversion (`convert.py`) against the JAX package's and the root
`convert.py` (tests/test_preprocess_n3v.py and
tests/test_preprocess_technicolor.py on the port).

Neither `colmap` nor `ffmpeg` is installed here; the COLMAP CLI is stood in
by a stub on PATH that records its arguments and writes what the next step
reads, and triangulation by the fake triangulator of
tests/test_preprocess_technicolor.py:40.

- N3V: the LLFF poses reach the database and the `manual/` model as rigid
  world-to-camera poses; the port's database rows and model files equal
  JAX's on one capture, exactly;
- Technicolor: the pipeline end to end into the layout the port's reader
  reads, the database and model equal JAX's, and the broken-frame repair;
- the COLMAP drives (`run_colmap_triangulation`, `convert.main`) issue the
  same commands as JAX's and the root `convert.py`'s, and raise without a
  `colmap` on PATH; the resolution ladder's images equal the root's;
- frame extraction hands out what JAX's does (or fails as JAX's fails where
  no video decoder works).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_preprocess.py
"""
import json
import os
import shutil
import sqlite3
import stat
import sys

import numpy as np
import pytest
from PIL import Image

from ex4dgs_tpu_torch.data.colmap import qvec2rotmat, read_images_text, rotmat2qvec
from ex4dgs_tpu_torch.preprocess import technicolor as T
from ex4dgs_tpu_torch.preprocess.llff import llff_poses_to_w2c
from ex4dgs_tpu_torch.preprocess.pipeline import (build_n3v_database, extract_frames,
                                                   run_colmap_triangulation)
from test_preprocess_n3v import _make_capture as _make_n3v_capture
from test_preprocess_technicolor import _fake_triangulator
from test_preprocess_technicolor import _make_capture as _make_techni_capture

N_CAMS = 4


def _db_rows(path):
    con = sqlite3.connect(path)
    try:
        return {table: con.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()
                for table in ("cameras", "images", "keypoints", "descriptors", "matches",
                              "two_view_geometries")}
    finally:
        con.close()


def _same_rows(got, want):
    assert got.keys() == want.keys()
    for table in want:
        assert len(got[table]) == len(want[table]), table
        for g, w in zip(got[table], want[table]):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                if isinstance(b, float) and np.isnan(b):
                    assert isinstance(a, float) and np.isnan(a), table
                else:
                    assert a == b and type(a) is type(b), (table, a, b)


def _same_tree(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        g, w = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if os.path.isdir(w):
            _same_tree(g, w)
        elif name.endswith(".db"):
            _same_rows(_db_rows(g), _db_rows(w))
        else:
            assert open(g, "rb").read() == open(w, "rb").read(), name


def test_rotmat2qvec_matches_jax():
    from ex4dgs_tpu.data.colmap import rotmat2qvec as jrotmat2qvec

    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        R = qvec2rotmat(q / np.linalg.norm(q))
        np.testing.assert_array_equal(rotmat2qvec(R), jrotmat2qvec(R))
        np.testing.assert_allclose(qvec2rotmat(rotmat2qvec(R)), R, atol=1e-12)


def test_build_n3v_database(tmp_path):
    """tests/test_preprocess_n3v.py's case on the port."""
    root = str(tmp_path)
    poses = _make_n3v_capture(root)
    project = build_n3v_database(root, offset=0)
    for i in range(N_CAMS):
        assert os.path.exists(os.path.join(project, "input", f"cam{i:02d}.png"))
    rows = _db_rows(os.path.join(project, "input.db"))
    assert len(rows["cameras"]) == len(rows["images"]) == N_CAMS
    images = read_images_text(os.path.join(project, "manual", "images.txt"))
    assert len(images) == N_CAMS
    w2c_ref = llff_poses_to_w2c(poses.transpose(1, 2, 0))
    by_name = {im.name: im for im in images.values()}
    for i in range(N_CAMS):
        im = by_name[f"cam{i:02d}.png"]
        R = qvec2rotmat(im.qvec)
        np.testing.assert_allclose(R, w2c_ref[i][:3, :3], atol=1e-6)
        np.testing.assert_allclose(im.tvec, w2c_ref[i][:3, 3], atol=1e-6)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
        ang = 0.3 * i
        np.testing.assert_allclose(R @ np.array([np.sin(ang), 0.0, np.cos(ang)]), [0, 0, 1],
                                   atol=1e-6)


def test_n3v_database_equals_jax(tmp_path):
    from ex4dgs_tpu.preprocess.pipeline import build_n3v_database as jbuild

    for name in ("port", "jax"):
        os.makedirs(tmp_path / name)
        _make_n3v_capture(str(tmp_path / name))
    got = build_n3v_database(str(tmp_path / "port"), offset=0)
    want = jbuild(str(tmp_path / "jax"), offset=0)
    assert os.path.basename(got) == os.path.basename(want) == "colmap_0"
    _same_tree(got, want)


def test_technicolor_pipeline_end_to_end(tmp_path):
    """tests/test_preprocess_technicolor.py's case on the port, read back by
    the port's reader."""
    from ex4dgs_tpu_torch.data.readers import read_technicolor_scene
    from ex4dgs_tpu_torch.models.config import ModelConfig

    sd = _make_techni_capture(str(tmp_path))
    projects = T.prepare_technicolor_scene(sd, offsets=[1], triangulator=_fake_triangulator)
    assert projects == [os.path.join(sd, "colmap_1")]
    inp = os.path.join(sd, "colmap_1", "input")
    assert sorted(os.listdir(inp)) == [f"cam{c:02d}.png" for c in range(3)]
    con = sqlite3.connect(os.path.join(sd, "colmap_1", "input.db"))
    cams = con.execute("SELECT camera_id, model, width, height FROM cameras").fetchall()
    assert len(cams) == 3 and all(m == 1 for _, m, _, _ in cams)
    assert all(w == T.TECHNI_WIDTH and h == T.TECHNI_HEIGHT for *_, w, h in cams)
    imgs = con.execute("SELECT name, prior_tx FROM images ORDER BY image_id").fetchall()
    con.close()
    assert [n for n, _ in imgs] == [f"cam{c:02d}.png" for c in range(3)]
    np.testing.assert_allclose([t for _, t in imgs], [0.0, 0.3, 0.6])
    cfg = ModelConfig(loader="technicolor", eval=False, start_timestamp=1, end_timestamp=4,
                      resolution=1)
    info = read_technicolor_scene(sd, cfg)
    assert len(info.train_cameras) == 3 * 3
    assert info.point_cloud.points.shape[0] == 50
    assert info.nerf_normalization["radius"] == 1
    assert sorted({c.timestamp for c in info.train_cameras}) == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError):
        T.prepare_technicolor_scene(sd, triangulator=_fake_triangulator)  # unknown scene


def test_technicolor_equals_jax(tmp_path):
    from ex4dgs_tpu.preprocess import technicolor as JT

    got = T.prepare_technicolor_scene(_make_techni_capture(str(tmp_path / "port")),
                                      offsets=[1, 2], triangulator=_fake_triangulator)
    want = JT.prepare_technicolor_scene(_make_techni_capture(str(tmp_path / "jax")),
                                        offsets=[1, 2], triangulator=_fake_triangulator)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        _same_tree(g, w)
    assert T.SCENE_WINDOWS == JT.SCENE_WINDOWS and T.BIRTHDAY_FIXUPS == JT.BIRTHDAY_FIXUPS


def test_fix_broken_image(tmp_path):
    """tests/test_preprocess_technicolor.py's case on the port, and the
    repaired frame equal to JAX's repair of the same file."""
    from ex4dgs_tpu.preprocess import technicolor as JT

    good = np.full((16, 16, 3), 200, np.uint8)
    ref_p = str(tmp_path / "ref.png")
    Image.fromarray(good).save(ref_p)
    big = np.random.default_rng(0).integers(0, 255, (64, 64, 3)).astype(np.uint8)
    ref_big = str(tmp_path / "refbig.png")
    Image.fromarray(np.full((64, 64, 3), 99, np.uint8)).save(ref_big)
    repaired = {}
    for name, fix in (("port", T.fix_broken_image), ("jax", JT.fix_broken_image)):
        broken_p = str(tmp_path / f"broken_{name}.png")
        Image.fromarray(big).save(broken_p)
        raw = open(broken_p, "rb").read()
        open(broken_p, "wb").write(raw[: len(raw) // 2])
        assert fix(broken_p, ref_big) is True
        repaired[name] = np.asarray(Image.open(broken_p))
    out = repaired["port"]
    assert out.shape == (64, 64, 3) and (out != 0).any()
    np.testing.assert_array_equal(out, repaired["jax"])
    assert T.fix_broken_image(ref_p, ref_big) is False
    np.testing.assert_array_equal(np.asarray(Image.open(ref_p)), good)


STUB = """#!{python}
import json, os, sys
args = sys.argv[1:]
with open(os.environ["COLMAP_STUB_LOG"], "a") as f:
    f.write(json.dumps(args) + "\\n")
if args and args[0] == "image_undistorter":
    out = args[args.index("--output_path") + 1]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    open(os.path.join(out, "sparse", "cameras.bin"), "wb").close()
"""


@pytest.fixture()
def stub_colmap(tmp_path, monkeypatch):
    """A `colmap` on PATH that appends its arguments to a log (returned)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    exe = bin_dir / "colmap"
    exe.write_text(STUB.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "colmap.log"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("COLMAP_STUB_LOG", str(log))

    def calls():
        if not log.exists():
            return []
        with open(log) as f:
            out = [json.loads(line) for line in f]
        log.unlink()
        return out

    return calls


def _relative(calls, root):
    return [[a.replace(str(root), "<root>") for a in c] for c in calls]


def test_triangulation_commands_equal_jax(tmp_path, stub_colmap):
    from ex4dgs_tpu.preprocess.pipeline import run_colmap_triangulation as jrun

    got_calls = {}
    for name, fn in (("port", run_colmap_triangulation), ("jax", jrun)):
        root = tmp_path / name
        os.makedirs(root)
        _make_n3v_capture(str(root))
        project = build_n3v_database(str(root), offset=0)
        fn(project)
        got_calls[name] = _relative(stub_colmap(), root)
        assert os.path.exists(os.path.join(project, "sparse", "0", "cameras.bin"))
    assert [c[0] for c in got_calls["port"]] == ["feature_extractor", "exhaustive_matcher",
                                                 "point_triangulator", "image_undistorter"]
    assert got_calls["port"] == got_calls["jax"]


def test_colmap_drives_raise_without_colmap(tmp_path, monkeypatch):
    from ex4dgs_tpu_torch import convert

    empty = tmp_path / "empty_bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(RuntimeError, match="COLMAP binary not found"):
        run_colmap_triangulation(str(tmp_path))
    with pytest.raises(RuntimeError, match="COLMAP binary not found"):
        convert.main(["-s", str(tmp_path)])


def _write_input(root, n=3):
    rng = np.random.default_rng(2)
    os.makedirs(root / "input")
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (40, 56, 3)).astype(np.uint8)).save(
            root / "input" / f"{i:03d}.png")


@pytest.mark.parametrize("flags", [[], ["--skip_matching"], ["--camera", "PINHOLE"]],
                         ids=["sfm", "skip_matching", "pinhole"])
def test_convert_commands_equal_root_convert(tmp_path, stub_colmap, flags):
    import importlib.util

    from ex4dgs_tpu_torch import convert

    spec = importlib.util.spec_from_file_location(
        "root_convert", os.path.join(os.path.dirname(os.path.dirname(__file__)), "convert.py"))
    root_convert = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_convert)
    got_calls = {}
    for name, main in (("port", convert.main), ("root", root_convert.main)):
        root = tmp_path / name
        _write_input(root)
        if "--skip_matching" in flags:
            os.makedirs(root / "distorted" / "sparse" / "0")
        main(["-s", str(root), *flags])
        got_calls[name] = _relative(stub_colmap(), root)
        assert os.path.exists(root / "sparse" / "0" / "cameras.bin")
    assert got_calls["port"] == got_calls["root"]
    want = ["image_undistorter"] if "--skip_matching" in flags else [
        "feature_extractor", "exhaustive_matcher", "mapper", "image_undistorter"]
    assert [c[0] for c in got_calls["port"]] == want


def test_resolution_ladder_equals_root(tmp_path):
    import importlib.util

    from ex4dgs_tpu_torch import convert

    spec = importlib.util.spec_from_file_location(
        "root_convert", os.path.join(os.path.dirname(os.path.dirname(__file__)), "convert.py"))
    root_convert = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_convert)
    for name, fn in (("port", convert.make_resolution_ladder),
                     ("root", root_convert.make_resolution_ladder)):
        _write_input(tmp_path / name)
        shutil.copytree(tmp_path / name / "input", tmp_path / name / "images")
        fn(str(tmp_path / name))
    for factor in (2, 4, 8):
        for i in range(3):
            got = np.asarray(Image.open(tmp_path / "port" / f"images_{factor}" / f"{i:03d}.png"))
            want = np.asarray(Image.open(tmp_path / "root" / f"images_{factor}" / f"{i:03d}.png"))
            assert got.shape == (max(1, 40 // factor), max(1, 56 // factor), 3)
            np.testing.assert_array_equal(got, want)


def test_extract_frames_as_jax(tmp_path):
    """Frames of one short video through both packages' extract_frames:
    the same PNGs, or the same failure where no decoder here reads it."""
    from ex4dgs_tpu.preprocess.pipeline import extract_frames as jextract

    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (32, 48, 3)).astype(np.uint8) for _ in range(4)]
    results = {}
    for name, fn in (("port", extract_frames), ("jax", jextract)):
        video = str(tmp_path / name / "cam00.mp4")
        os.makedirs(os.path.dirname(video))
        writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (48, 32))
        for f in frames:
            writer.write(f)
        writer.release()
        try:
            out = fn(video, n_frames=3)
            results[name] = [np.asarray(Image.open(os.path.join(out, f"{i}.png")))
                             for i in range(len(os.listdir(out)))]
        except Exception as e:  # no decoder on this machine reads the file
            results[name] = type(e)
    if isinstance(results["jax"], type):
        assert results["port"] is results["jax"]
    else:
        assert len(results["port"]) == len(results["jax"]) > 0
        for g, w in zip(results["port"], results["jax"]):
            np.testing.assert_array_equal(g, w)
