"""Generic COLMAP scene conversion — the reference's convert.py:1-124.

    python -m ex4dgs_tpu_torch.convert -s <source_path> [--camera OPENCV]
        [--skip_matching] [--resize]

Counterpart of the repository's root `convert.py` (which predates the
port), the same commands and layout.

Given <source_path>/input/ full of images, runs COLMAP feature extraction ->
exhaustive matching -> mapper (unknown poses: full SfM, unlike the known-pose
point_triangulator used by the dataset pipelines) -> undistortion into the
sparse/0 layout the COLMAP reader consumes, then optionally emits the
images_{2,4,8} resolution ladder (PIL LANCZOS instead of ImageMagick).
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run_colmap_sfm(source_path: str, camera: str = "OPENCV",
                   skip_matching: bool = False) -> None:
    if shutil.which("colmap") is None:
        raise RuntimeError("COLMAP binary not found on PATH")
    env = dict(os.environ, QT_QPA_PLATFORM="offscreen")

    def run(*args):
        subprocess.run(args, check=True, env=env)

    db = os.path.join(source_path, "distorted", "database.db")
    inp = os.path.join(source_path, "input")
    sparse = os.path.join(source_path, "distorted", "sparse")
    if not skip_matching:
        os.makedirs(sparse, exist_ok=True)
        run("colmap", "feature_extractor", "--database_path", db,
            "--image_path", inp, "--ImageReader.single_camera", "1",
            "--ImageReader.camera_model", camera,
            "--SiftExtraction.use_gpu", "0")
        run("colmap", "exhaustive_matcher", "--database_path", db,
            "--SiftMatching.use_gpu", "0")
        run("colmap", "mapper", "--database_path", db, "--image_path", inp,
            "--output_path", sparse,
            "--Mapper.ba_global_function_tolerance=0.000001")
    run("colmap", "image_undistorter", "--image_path", inp,
        "--input_path", os.path.join(sparse, "0"),
        "--output_path", source_path, "--output_type", "COLMAP")
    # normalize layout -> sparse/0
    sp = os.path.join(source_path, "sparse")
    os.makedirs(os.path.join(sp, "0"), exist_ok=True)
    for f in os.listdir(sp):
        if f != "0":
            shutil.move(os.path.join(sp, f), os.path.join(sp, "0", f))


def make_resolution_ladder(source_path: str) -> None:
    """images_{2,4,8} downsampled copies (convert.py:92-124), PIL LANCZOS."""
    from PIL import Image

    src = os.path.join(source_path, "images")
    for factor in (2, 4, 8):
        dst = os.path.join(source_path, f"images_{factor}")
        os.makedirs(dst, exist_ok=True)
        for name in os.listdir(src):
            img = Image.open(os.path.join(src, name))
            img = img.resize((max(1, img.width // factor),
                              max(1, img.height // factor)), Image.LANCZOS)
            img.save(os.path.join(dst, name))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ex4dgs_tpu_torch.convert")
    ap.add_argument("--source_path", "-s", required=True)
    ap.add_argument("--camera", default="OPENCV")
    ap.add_argument("--no_gpu", action="store_true")  # accepted for parity
    ap.add_argument("--skip_matching", action="store_true")
    ap.add_argument("--resize", action="store_true")
    args = ap.parse_args(argv)
    run_colmap_sfm(args.source_path, camera=args.camera,
                   skip_matching=args.skip_matching)
    if args.resize:
        make_resolution_ladder(args.source_path)
    print("Done.")


if __name__ == "__main__":
    sys.exit(main())
