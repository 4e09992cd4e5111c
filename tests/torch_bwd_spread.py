"""How far apart float32 evaluations of the backward closed form land on the
backward kernel's test frames, on the GPU:

    python tests/torch_bwd_spread.py

For the frames of tests/test_torch_backward.py's `cuda` cases (a small
scene, the cull's near-threshold and near-singular sweeps, the adversarial
frame) at 32x16, 16x16, 8x4 and 24x4, with kernel A's accum and tfinal and
the seeded cotangents of bench_frame.cotangents, it prints the worst
|a - b| / (BWD_RTOL |b| + BWD_ATOL max |b| of the row group) per row group
(bwd_errors; 1 is the limit) of:

  * the plain version walked one instance at a time (chunk=1) against the
    plain version at its default chunk of 64: the plain version's spread
    against itself;
  * the kernel against the plain version;
  * the kernel against its twin composite_tiles_bwd_walk (0 when bit-equal).

It needs a CUDA device and nvcc (the kernels are built at first use).
"""
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ex4dgs_tpu_torch.bench_frame import cotangents  # noqa: E402
from ex4dgs_tpu_torch.ops import rasterize_cuda as trc  # noqa: E402
from test_torch_backward import CARD_TILES, _one_range_per_tile  # noqa: E402
from test_torch_composite import _adversarial_frame, _scene_frame  # noqa: E402
from test_torch_cull import _sweep_frame  # noqa: E402


def frames(tile, dev):
    yield "scene", _scene_frame(tile, dev)
    for kind in ("threshold", "singular"):
        data, _, starts, stops, gx = _sweep_frame(kind, tile, dev)
        data, starts, stops = _one_range_per_tile(data, starts, stops)
        gid = torch.arange(data.shape[1], dtype=torch.int32, device=dev)
        yield kind, (data, gid, starts, stops, gx)
    yield "adversarial", _adversarial_frame(tile, dev)


def worst(a, b, lo, hi) -> str:
    return " ".join(f"{k} {e[1]:.3g}" for k, e in trc.bwd_errors(a, b, lo, hi).items())


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", flush=True)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"# {card}", flush=True)
    for tile in CARD_TILES:
        for name, (data, gid, starts, stops, gx) in frames(tile, dev):
            kw = dict(grid_x=gx, tile_x=tile[0], tile_y=tile[1])
            accum, tfinal, _ = trc.composite_tiles_fwd(data, gid, starts, stops, track_idx=False,
                                                       **kw)
            gacc, acdot, gend = cotangents(accum)
            args = (data, starts, stops, gacc, acdot, gend, tfinal)
            plain = trc.composite_tiles_bwd_plain(*args, **kw)
            plain1 = trc.composite_tiles_bwd_plain(*args, chunk=1, **kw)
            kernel = trc.composite_tiles_bwd(*args, **kw)
            twin = trc.composite_tiles_bwd_walk(*args, **kw)
            lo, hi = int(starts[0]), int(stops[-1])
            print(f"# {tile[0]}x{tile[1]} {name}: plain chunk=1 vs plain "
                  f"[{worst(plain1, plain, lo, hi)}]; kernel vs plain "
                  f"[{worst(kernel, plain, lo, hi)}]; kernel vs twin [{worst(kernel, twin, lo, hi)}]"
                  f", bit-equal {torch.equal(kernel, twin)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
