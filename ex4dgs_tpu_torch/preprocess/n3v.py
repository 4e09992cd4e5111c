"""N3V capture preparation CLI — scripts/preprocess_n3v.py's surface (the
reference's scripts/pre_n3d.py): extract the frames of every camera video,
seed a known-pose COLMAP project at frame `--offset` and triangulate.

    python -m ex4dgs_tpu_torch.preprocess.n3v --videopath /data/cook_spinach \
        [--offset 0] [--frames 300]

Host code (numpy, sqlite, the `colmap` binary): it takes no --device.
"""
from __future__ import annotations

import argparse

from .pipeline import prepare_n3v_scene


def main(argv=None) -> str:
    p = argparse.ArgumentParser(prog="python -m ex4dgs_tpu_torch.preprocess.n3v")
    p.add_argument("--videopath", required=True)
    p.add_argument("--offset", type=int, default=0)
    p.add_argument("--frames", type=int, default=300)
    args = p.parse_args(argv)
    project = prepare_n3v_scene(args.videopath, offset=args.offset, n_frames=args.frames)
    print(f"prepared {project}")
    return project


if __name__ == "__main__":
    main()
