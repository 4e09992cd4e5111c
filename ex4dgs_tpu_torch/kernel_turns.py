"""Time kernel A (csrc/composite_fwd.cu) in turns against other builds of
its C entry point, on the bench frame, and compare their outputs bit for bit.

    python -m ex4dgs_tpu_torch.kernel_turns --other NAME=path/to/composite_fwd.cu ...

Each `--other` source exports `composite_fwd` with the signature of
kernels.py (an earlier revision of the kernel, or a variant of it) and is
built with the package's nvcc flags into `_build/` beside its source. The
frame is bench_frame's (chip_smoke.py phase 3's), at t = 1, packed once per
tile shape (TILES). At each tile shape the script

  * checks every build against the committed kernel: accum, tfinal and
    bestidx bit-equal, or the largest differences;
  * prints each build's tfinal_rel_err against the plain version (the
    largest relative difference off the latch, held to TF_RTOL);
  * times the builds in turns, committed first, then the others, then the
    same in reverse order (REPS launches per turn, CUDA events), and prints
    each build's mean of its two turns and its ratio to the committed
    kernel's, beside the card's name and power limit.

It needs one CUDA device and nvcc, and runs nothing on the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from . import kernels
from .bench_frame import bench_scene, cuda_ms, pack_frame
from .ops.rasterize_cuda import TF_RTOL, composite_tiles_plain, tfinal_rel_err

TILES = ((32, 16), (16, 16))
REPS = 20


def _other(spec: str):
    """NAME=path -> (name, bound composite_fwd, nvcc's output)."""
    name, _, path = spec.partition("=")
    src = Path(path).resolve()
    lib_path, text = kernels.build(src, src.parent / "_build")
    fn = ctypes.CDLL(str(lib_path)).composite_fwd
    fn.argtypes, fn.restype = kernels._SIGNATURES["composite_fwd"], ctypes.c_int
    return name, fn, text


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", action="append", default=[], help="NAME=path.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", flush=True)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    kernels.load_all()
    logs = {"committed": kernels.build_logs.get("composite_fwd", "")}
    others = [_other(s) for s in args.other]
    logs.update({name: text for name, _, text in others})
    for name, text in logs.items():
        print("\n".join(f"# {name}: {ln.strip()}" for ln in text.strip().splitlines()))
    scene = bench_scene(dev)
    ok = True
    for tx, ty in TILES:
        data, gid, starts, stops, gx, _ = pack_frame(scene, tx, ty)
        T, npix, cap = starts.shape[0], tx * ty, data.shape[1]
        kw = dict(grid_x=gx, tile_x=tx, tile_y=ty, track_idx=True)

        def committed():
            return kernels.composite_fwd(data, gid, starts, stops, **kw)

        def runner(fn):
            def run():
                outs = (torch.empty((T, npix, 8), device=dev), torch.empty((T, npix, 1), device=dev),
                        torch.empty((T, npix, 1), dtype=torch.int32, device=dev))
                err = fn(data.data_ptr(), gid.data_ptr(), starts.data_ptr(), stops.data_ptr(),
                         *(o.data_ptr() for o in outs), cap, T, gx, tx, ty, 1,
                         torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                return outs
            return run

        runs = {"committed": committed}
        runs.update({name: runner(fn) for name, fn, _ in others})
        want = committed()
        plain = composite_tiles_plain(data, gid, starts, stops, **kw)
        torch.cuda.synchronize()
        for name, run in runs.items():
            got, again = run(), run()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            rel, n_latch = tfinal_rel_err(got[1], plain[1])
            diffs = ", ".join(f"{k} {(a.float() - b.float()).abs().max().item():.3g}"
                              for k, a, b in zip(("accum", "tfinal", "bestidx"), got, want))
            print(f"# {tx}x{ty} {name}: bit-equal to committed {same} ({diffs}); two launches "
                  f"bit-equal {repeat}; tfinal relative to plain off the latch {rel:.3g} "
                  f"(TF_RTOL {TF_RTOL:g}; {n_latch} pixels on it)", flush=True)
            ok = ok and repeat and (same or name != "committed")
        del plain
        names = list(runs)
        times = {n: [] for n in names}
        for n in names + names[::-1]:
            times[n].append(cuda_ms(runs[n], REPS))
        base = sum(times["committed"]) / 2
        for n in names:
            t = sum(times[n]) / 2
            print(f"# {tx}x{ty} {n}: {t:.4f} ms (turns {times[n][0]:.4f}, {times[n][1]:.4f}), "
                  f"{t / base:.3f} of committed; {T} tiles, {int(stops[-1] - starts[0])} "
                  f"instances; {card}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
