"""Dataset preparation pipelines (the reference's scripts/pre_n3d.py,
pre_technicolor.py and COLMAP CLI wrappers, etc_utils.py:101-161).

Counterpart of `ex4dgs_tpu/preprocess/pipeline.py`.

Each capture: extract per-camera PNG frames, seed a COLMAP database with the
known poses at frame `offset`, run feature extraction -> exhaustive matching
-> point_triangulator -> image_undistorter, leaving `colmap_<offset>/sparse/0`
+ per-camera frame dirs in the layout data/readers.py consumes. The COLMAP
binary and a video decoder are external tools — both are feature-gated with
clear errors when absent.
"""
from __future__ import annotations

import glob
import os
import shutil
import subprocess

import numpy as np

from ..data.colmap import rotmat2qvec
from .colmap_db import ColmapDatabase
from .llff import llff_poses_to_w2c, load_poses_bounds


def extract_frames(video_path: str, out_dir: str | None = None,
                   n_frames: int = 300, zero_pad: int = 0) -> str:
    """Decode a .mp4 into numbered PNGs (pre_n3d.py:38-63)."""
    out_dir = out_dir or video_path[:-4]
    os.makedirs(out_dir, exist_ok=True)
    existing = len(glob.glob(os.path.join(out_dir, "*.png")))
    if existing >= n_frames:
        return out_dir
    try:
        import imageio.v3 as iio

        frames = iio.imiter(video_path)
    except Exception:
        try:
            import cv2

            def _cv_iter():
                cap = cv2.VideoCapture(video_path)
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    yield frame[..., ::-1]
                cap.release()

            frames = _cv_iter()
        except Exception as e:
            raise RuntimeError(
                "no video decoder available (need imageio[ffmpeg] or opencv); "
                f"extract frames externally into {out_dir}"
            ) from e
    from PIL import Image

    for i, frame in enumerate(frames):
        if i >= n_frames:
            break
        name = f"{i:0{zero_pad}d}.png" if zero_pad else f"{i}.png"
        Image.fromarray(np.asarray(frame)).save(os.path.join(out_dir, name))
    return out_dir


def build_n3v_database(scene_dir: str, offset: int = 0) -> str:
    """Seed colmap_<offset>/ with the LLFF poses + frame-`offset` images
    (pre_n3d.py:66-160)."""
    video_paths = sorted(glob.glob(os.path.join(scene_dir, "cam*.mp4")))
    if not video_paths:
        video_paths = sorted(
            d + ".mp4" for d in glob.glob(os.path.join(scene_dir, "cam*"))
            if os.path.isdir(d)
        )
    project = os.path.join(scene_dir, f"colmap_{offset}")
    input_dir = os.path.join(project, "input")
    manual = os.path.join(project, "manual")
    os.makedirs(input_dir, exist_ok=True)
    os.makedirs(manual, exist_ok=True)

    # frame `offset` of each camera -> input/camXX.png
    for v in video_paths:
        cam_dir = v[:-4]
        src = os.path.join(cam_dir, f"{offset}.png")
        shutil.copy(src, os.path.join(input_dir, os.path.basename(cam_dir) + ".png"))

    db_path = os.path.join(project, "input.db")
    if os.path.exists(db_path):
        os.remove(db_path)
    db = ColmapDatabase(db_path)

    poses, _bounds, (H, W, focal) = load_poses_bounds(
        os.path.join(scene_dir, "poses_bounds.npy")
    )
    w2c = llff_poses_to_w2c(poses)
    images_txt, cameras_txt = [], []
    for i, v in enumerate(video_paths):
        name = os.path.basename(v)[:-4] + ".png"
        m = w2c[i]
        q = rotmat2qvec(m[:3, :3])
        t = m[:3, 3]
        params = np.array([focal, focal, W // 2, H // 2], np.float64)
        cam_id = db.add_camera(1, W, H, params)  # model 1 = PINHOLE
        db.add_image(name, cam_id, prior_q=q, prior_t=t, image_id=i + 1)
        images_txt.append(
            f"{i + 1} " + " ".join(str(x) for x in q) + " "
            + " ".join(str(x) for x in t) + f" {cam_id} {name}\n\n"
        )
        cameras_txt.append(
            f"{i + 1} PINHOLE {W} {H} {focal} {focal} {W // 2} {H // 2}\n"
        )
    db.commit()
    db.close()
    with open(os.path.join(manual, "images.txt"), "w") as f:
        f.writelines(images_txt)
    with open(os.path.join(manual, "cameras.txt"), "w") as f:
        f.writelines(cameras_txt)
    open(os.path.join(manual, "points3D.txt"), "w").close()
    return project


def run_colmap_triangulation(project: str) -> None:
    """Known-pose triangulation via the COLMAP CLI (etc_utils.py:101-161)."""
    if shutil.which("colmap") is None:
        raise RuntimeError("COLMAP binary not found on PATH")
    env = dict(os.environ, QT_QPA_PLATFORM="offscreen")
    db = os.path.join(project, "input.db")
    inp = os.path.join(project, "input")
    manual = os.path.join(project, "manual")
    distorted = os.path.join(project, "distorted", "sparse")
    os.makedirs(distorted, exist_ok=True)

    def run(*args):
        subprocess.run(args, check=True, env=env)

    run("colmap", "feature_extractor", "--database_path", db,
        "--image_path", inp, "--SiftExtraction.edge_threshold", "30",
        "--SiftExtraction.peak_threshold", "0.004")
    run("colmap", "exhaustive_matcher", "--database_path", db)
    run("colmap", "point_triangulator", "--database_path", db,
        "--image_path", inp, "--output_path", distorted,
        "--input_path", manual,
        "--Mapper.ba_global_function_tolerance=0.000001")
    run("colmap", "image_undistorter", "--image_path", inp,
        "--input_path", distorted, "--output_path", project,
        "--output_type", "COLMAP")
    # normalize layout -> sparse/0
    sparse = os.path.join(project, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))


def prepare_n3v_scene(scene_dir: str, offset: int = 0, n_frames: int = 300):
    """Full N3V pipeline: frames -> database -> triangulation."""
    for v in sorted(glob.glob(os.path.join(scene_dir, "cam*.mp4"))):
        extract_frames(v, n_frames=n_frames)
    project = build_n3v_database(scene_dir, offset)
    run_colmap_triangulation(project)
    return project
