"""Technicolor light-field capture preparation (scripts/pre_technicolor.py:46-236
+ preprocess_all_techni.sh in the reference).

Counterpart of `ex4dgs_tpu/preprocess/technicolor.py`.

Input layout (as distributed): a scene directory containing
  cameras_parameters.txt                      - one row per camera
  <Scene>_undist_<frame:05d>_<cam:02d>.png    - undistorted frames

Per selected frame offset this produces colmap_<offset>/ with
  input/cam<NN>.png      - that frame from every camera
  input.db               - COLMAP sqlite DB seeded with known intrinsics/poses
  manual/{images,cameras,points3D}.txt - known-pose model for point_triangulator
and then drives the COLMAP CLI (feature extract -> exhaustive match ->
point_triangulator -> image_undistorter) into sparse/0 — exactly the layout
data/readers.py::read_technicolor_scene consumes.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
import shutil

import numpy as np

from .colmap_db import ColmapDatabase
from .pipeline import run_colmap_triangulation

TECHNI_WIDTH = 2048
TECHNI_HEIGHT = 1088

# The reference's per-scene frame windows (preprocess_all_techni.sh:1-5).
SCENE_WINDOWS = {
    "Birthday": (151, 201),
    "Fabien": (51, 101),
    "Painter": (100, 150),
    "Theater": (51, 101),
    "Train": (151, 201),
}


@dataclasses.dataclass
class TechniCamera:
    index: int
    fx: float
    cx: float
    cy: float
    qvec: np.ndarray  # [4] w x y z (COLMAP convention, world->cam)
    tvec: np.ndarray  # [3]


def parse_calibration(path: str) -> list[TechniCamera]:
    """Parse cameras_parameters.txt (pre_technicolor.py:65-88): after a header
    row, each row is `fx cx cy <k1> <k2> qw qx qy qz tx ty tz` per camera;
    fy := fx."""
    cams = []
    with open(path) as f:
        rows = [r for r in f.read().splitlines() if r.strip()]
    for idx, row in enumerate(rows[1:]):
        vals = [float(c) for c in row.split() if c.strip()]
        cams.append(TechniCamera(
            index=idx,
            fx=vals[0], cx=vals[1], cy=vals[2],
            qvec=np.array(vals[5:9], np.float64),
            tvec=np.array(vals[9:12], np.float64),
        ))
    return cams


def frame_pngs(scene_dir: str, offset: int) -> list[str]:
    """All cameras' frame-`offset` images: <Scene>_undist_<offset:05d>_<cam>.png"""
    return sorted(glob.glob(
        os.path.join(scene_dir, f"*_undist_{offset:05d}_*.png")
    ))


def copy_frame_images(scene_dir: str, offset: int) -> str:
    """input/cam<NN>.png for one offset (imagecopy, pre_technicolor.py:128-147)."""
    target = os.path.join(scene_dir, f"colmap_{offset}", "input")
    os.makedirs(target, exist_ok=True)
    pngs = frame_pngs(scene_dir, offset)
    if not pngs:
        raise FileNotFoundError(
            f"no *_undist_{offset:05d}_*.png frames in {scene_dir}"
        )
    for p in pngs:
        cam = re.findall("[0-9]+", os.path.basename(p))[-1]
        shutil.copy(p, os.path.join(target, f"cam{cam}.png"))
    return target


def build_technicolor_database(scene_dir: str, offset: int,
                               width: int = TECHNI_WIDTH,
                               height: int = TECHNI_HEIGHT) -> str:
    """Seed colmap_<offset>/ with the calibrated poses
    (convertmodel2dbfiles, pre_technicolor.py:46-125)."""
    cams = parse_calibration(os.path.join(scene_dir, "cameras_parameters.txt"))
    project = os.path.join(scene_dir, f"colmap_{offset}")
    manual = os.path.join(project, "manual")
    os.makedirs(manual, exist_ok=True)

    db_path = os.path.join(project, "input.db")
    if os.path.exists(db_path):
        os.remove(db_path)
    db = ColmapDatabase(db_path)

    images_txt, cameras_txt = [], []
    for c in cams:
        name = f"cam{c.index:02d}.png"
        params = np.array([c.fx, c.fx, c.cx, c.cy], np.float64)
        cam_id = db.add_camera(1, width, height, params)  # model 1 = PINHOLE
        db.add_image(name, cam_id, prior_q=c.qvec, prior_t=c.tvec,
                     image_id=c.index + 1)
        images_txt.append(
            f"{c.index + 1} " + " ".join(str(x) for x in c.qvec) + " "
            + " ".join(str(x) for x in c.tvec) + f" {cam_id} {name}\n\n"
        )
        cameras_txt.append(
            f"{c.index + 1} PINHOLE {width} {height} "
            f"{c.fx} {c.fx} {c.cx} {c.cy}\n"
        )
    db.commit()
    db.close()
    with open(os.path.join(manual, "images.txt"), "w") as f:
        f.writelines(images_txt)
    with open(os.path.join(manual, "cameras.txt"), "w") as f:
        f.writelines(cameras_txt)
    open(os.path.join(manual, "points3D.txt"), "w").close()
    return project


def fix_broken_image(path: str, ref_path: str) -> bool:
    """Repair a truncated PNG by compositing the zero-filled region from a
    neighboring frame (fixbroken, pre_technicolor.py:172-195). Returns True
    if a repair was applied."""
    from PIL import Image, ImageFile

    try:
        img = Image.open(path)
        img.verify()
        return False  # already intact
    except Exception:
        pass
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    try:
        broken = np.asarray(Image.open(path).convert("RGB"))
    finally:
        ImageFile.LOAD_TRUNCATED_IMAGES = False
    ref = np.asarray(Image.open(ref_path).convert("RGB"))
    mask = broken == 0
    composed = broken * (~mask) + ref * mask
    Image.fromarray(composed.astype(np.uint8)).save(path)
    return True


# Known-broken Birthday frames (pre_technicolor.py:219-225).
BIRTHDAY_FIXUPS = [
    ("Birthday_undist_00012_09.png", "Birthday_undist_00013_09.png"),
    ("Birthday_undist_00173_09.png", "Birthday_undist_00172_09.png"),
    ("Birthday_undist_00255_02.png", "Birthday_undist_00254_02.png"),
]


def prepare_technicolor_scene(
    scene_dir: str,
    offsets: list[int] | None = None,
    triangulator=run_colmap_triangulation,
) -> list[str]:
    """Full pipeline for one scene. offsets defaults to the scene's reference
    training window start (the reader consumes colmap_<start_timestamp>).

    `triangulator` is injectable so environments without the COLMAP binary
    (and tests) can substitute their own known-pose triangulation."""
    scene = os.path.basename(os.path.normpath(scene_dir))
    if scene == "Birthday":
        for broken, ref in BIRTHDAY_FIXUPS:
            bp = os.path.join(scene_dir, broken)
            rp = os.path.join(scene_dir, ref)
            if os.path.exists(bp) and os.path.exists(rp):
                fix_broken_image(bp, rp)
    if offsets is None:
        if scene not in SCENE_WINDOWS:
            raise ValueError(
                f"unknown scene {scene!r}: pass offsets= explicitly"
            )
        offsets = [SCENE_WINDOWS[scene][0]]
    projects = []
    for offset in offsets:
        copy_frame_images(scene_dir, offset)
        project = build_technicolor_database(scene_dir, offset)
        triangulator(project)
        projects.append(project)
    return projects
