"""Time kernel A (csrc/composite_fwd.cu) or kernel B (csrc/composite_bwd.cu)
in turns against other builds of its C entry point, on the bench frame, and
compare their outputs.

    python -m ex4dgs_tpu_torch.kernel_turns --other NAME=path/to/composite_fwd.cu ...
    python -m ex4dgs_tpu_torch.kernel_turns --other NAME=path/to/composite_bwd.cu ...
    python -m ex4dgs_tpu_torch.kernel_turns --offsets [--other ...]

Each `--other` source exports `composite_fwd` or `composite_bwd` (an
earlier revision of the kernel, or a variant of it) and is built with the
package's nvcc flags into `_build/` beside its source; the entry point it
exports decides which committed kernel it is held against (with no
`--other`, kernel A alone is timed). Its arguments are passed by name, as
the `extern "C"` declaration in its source names them
(kernels.declared_signature), so a revision from before a change of the
C signature (e.g. one without the subpixel `offsets`) still runs.
With `--offsets`, every build composites the frame with bench_frame's
seeded subpixel offsets (a source without an `offsets` parameter is then
refused); without it, with none. The frame is bench_frame's (chip_smoke.py
phase 3's), at t = 1, packed once per tile shape (TILES). At each tile
shape the script

  * checks every build against the committed kernel: bit-equal outputs, or
    the largest differences, and names the other builds it is bit-equal to;
  * holds every build to the plain version: kernel A's tfinal_rel_err off
    the latch (TF_RTOL); kernel B's dgrad element by element (bwd_errors:
    BWD_RTOL of itself plus BWD_ATOL of its row group's largest), on kernel
    A's accum and tfinal of the frame and the seeded cotangents of
    bench_frame.cotangents (chip_smoke.py phase 5's inputs);
  * times the builds in turns, committed first, then the others, then the
    same in reverse order (REPS launches per turn, CUDA events), and prints
    each build's mean of its two turns and its ratio to the committed
    kernel's, beside the card's name and power limit.

It fails when two launches of a build differ, when the committed kernel
differs from itself or, for kernel B, when any build breaks the tolerance.
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
from .bench_frame import bench_offsets, bench_scene, cotangents, cuda_ms, pack_frame
from .ops.rasterize_cuda import (BWD_ATOL, BWD_RTOL, TF_RTOL, bwd_errors,
                                 composite_tiles_bwd_plain, composite_tiles_plain,
                                 tfinal_rel_err, tile_offsets)

TILES = ((32, 16), (16, 16))
REPS = 20
ENTRIES = ("composite_fwd", "composite_bwd")


def _other(spec: str):
    """NAME=path -> (name, entry point, (bound C function, its parameter
    names), nvcc's output)."""
    name, _, path = spec.partition("=")
    src = Path(path).resolve()
    lib_path, text = kernels.build(src, src.parent / "_build")
    lib = ctypes.CDLL(str(lib_path))
    entry = next((e for e in ENTRIES if hasattr(lib, e)), None)
    if entry is None:
        raise SystemExit(f"{src} exports none of {ENTRIES}")
    params = kernels.declared_signature(src.read_text(), entry)
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = [t for _, t in params], ctypes.c_int
    return name, entry, (fn, [n for n, _ in params]), text


def call_args(names, values: dict, stream) -> list:
    """The arguments of a C entry point whose parameters are `names`, taken
    by name from `values` (which may hold more) and `stream`."""
    return [stream if n == "stream" else values[n] for n in names]


def _launcher(bound, make_outs, values):
    """A call of the bound C function on fresh outputs make_outs(), its
    arguments by name from values(outs)."""
    fn, names = bound

    def run():
        outs = make_outs()
        err = fn(*call_args(names, values(outs), torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return outs
    return run


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_runs(frame, tile, offsets, others, dev):
    """(runs, check): kernel A's builds on the frame at `tile` (with the
    per-tile subpixel `offsets`, or None), and the check of one build's
    outputs against the plain version (a note, ok)."""
    data, gid, starts, stops, gx, _ = frame
    tx, ty = tile
    T, npix, cap = starts.shape[0], tx * ty, data.shape[1]
    kw = dict(grid_x=gx, tile_x=tx, tile_y=ty, track_idx=True, offsets=offsets)

    def make_outs():
        return (torch.empty((T, npix, 8), device=dev), torch.empty((T, npix, 1), device=dev),
                torch.empty((T, npix, 1), dtype=torch.int32, device=dev))

    def values(outs):
        return dict(data=data.data_ptr(), gid=gid.data_ptr(), starts=starts.data_ptr(),
                    stops=stops.data_ptr(), offsets=_ptr(offsets), accum=outs[0].data_ptr(),
                    tfinal=outs[1].data_ptr(), bestidx=outs[2].data_ptr(), capacity=cap,
                    num_tiles=T, grid_x=gx, tile_x=tx, tile_y=ty, track_idx=1)

    runs = {"committed": lambda: kernels.composite_fwd(data, gid, starts, stops, **kw)}
    runs.update({name: _launcher(bound, make_outs, values) for name, bound in others})
    plain = composite_tiles_plain(data, gid, starts, stops, **kw)

    def check(got):
        rel, n_latch = tfinal_rel_err(got[1], plain[1])
        return (f"tfinal relative to plain off the latch {rel:.3g} (TF_RTOL {TF_RTOL:g}; "
                f"{n_latch} pixels on it)"), True

    return runs, check, ("accum", "tfinal", "bestidx")


def _bwd_runs(frame, tile, offsets, others, dev):
    """As _fwd_runs for kernel B, on kernel A's outputs of the frame and
    seeded cotangents."""
    data, gid, starts, stops, gx, _ = frame
    tx, ty = tile
    T, cap = starts.shape[0], data.shape[1]
    accum, tfinal, _ = kernels.composite_fwd(data, gid, starts, stops, grid_x=gx, tile_x=tx,
                                             tile_y=ty, track_idx=False, offsets=offsets)
    gacc, acdot, gend = cotangents(accum)
    bargs = (data, starts, stops, gacc, acdot, gend, tfinal)
    kw = dict(grid_x=gx, tile_x=tx, tile_y=ty, offsets=offsets)

    def make_outs():
        return (torch.zeros((16, cap), device=dev),)

    def values(outs):
        names = ("data", "starts", "stops", "gacc", "acdot", "gend", "tfinal")
        return dict(zip(names, (t.data_ptr() for t in bargs)), offsets=_ptr(offsets),
                    dgrad=outs[0].data_ptr(), capacity=cap, num_tiles=T, grid_x=gx,
                    tile_x=tx, tile_y=ty)

    runs = {"committed": lambda: (kernels.composite_bwd(*bargs, **kw),)}
    runs.update({name: _launcher(bound, make_outs, values) for name, bound in others})
    plain = composite_tiles_bwd_plain(*bargs, **kw)
    lo, hi = int(starts[0]), int(stops[-1])

    def check(got):
        errs = bwd_errors(got[0], plain, lo, hi)
        worst = max(e[1] for e in errs.values())
        outside = not (got[0][:, :lo].any() or got[0][:, hi:].any() or got[0][14:].any())
        note = (f"vs plain worst err/limit {worst:.3g} (BWD_RTOL {BWD_RTOL:g}, BWD_ATOL "
                f"{BWD_ATOL:g}; " + ", ".join(f"{k} {e[0]:.3g}" for k, e in errs.items())
                + f"); outside the ranges zero {outside}")
        return note, worst <= 1.0 and outside

    return runs, check, ("dgrad",)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", action="append", default=[], help="NAME=path.cu")
    parser.add_argument("--offsets", action="store_true",
                        help="composite with the bench frame's subpixel offsets")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", flush=True)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    kernels.load_all()
    others = [_other(s) for s in args.other]
    if args.offsets:
        lacking = [name for name, _, (_, names), _ in others if "offsets" not in names]
        if lacking:
            raise SystemExit(f"--offsets: {lacking} take no subpixel offsets")
    entries = [e for e in ENTRIES if any(o[1] == e for o in others)] or ["composite_fwd"]
    logs = {f"committed {e}": kernels.build_logs.get(e, "") for e in entries}
    logs.update({name: text for name, _, _, text in others})
    for name, text in logs.items():
        print("\n".join(f"# {name}: {ln.strip()}" for ln in text.strip().splitlines()))
    scene = bench_scene(dev)
    off_img = bench_offsets(dev) if args.offsets else None
    mode = "with subpixel offsets" if args.offsets else "without offsets"
    ok = True
    for tx, ty in TILES:
        frame = pack_frame(scene, tx, ty)
        n_inst = int(frame.stops[-1] - frame.starts[0])
        T = frame.starts.shape[0]
        offsets = (None if off_img is None else
                   tile_offsets(off_img, frame.grid_x, T // frame.grid_x, tx, ty))
        for entry in entries:
            mine = [(name, bound) for name, e, bound, _ in others if e == entry]
            setup = _fwd_runs if entry == "composite_fwd" else _bwd_runs
            runs, check, labels = setup(frame, (tx, ty), offsets, mine, dev)
            outs = {}
            for name, run in runs.items():
                got, again = run(), run()
                torch.cuda.synchronize()
                outs[name] = got
                repeat = all(torch.equal(a, b) for a, b in zip(got, again))
                same = all(torch.equal(a, b) for a, b in zip(got, outs["committed"]))
                twins = [n for n in outs if n not in (name, "committed")
                         and all(torch.equal(a, b) for a, b in zip(got, outs[n]))]
                diffs = ", ".join(f"{k} {(a.float() - b.float()).abs().max().item():.3g}"
                                  for k, a, b in zip(labels, got, outs["committed"]))
                note, good = check(got)
                print(f"# {tx}x{ty} {entry} {mode} {name}: bit-equal to committed {same} "
                      f"({diffs}); "
                      f"bit-equal to {twins or 'no earlier other'}; two launches bit-equal "
                      f"{repeat}; {note}", flush=True)
                ok = ok and repeat and good
            del outs
            names = list(runs)
            times = {n: [] for n in names}
            for n in names + names[::-1]:
                times[n].append(cuda_ms(runs[n], REPS))
            base = sum(times["committed"]) / 2
            for n in names:
                t = sum(times[n]) / 2
                print(f"# {tx}x{ty} {entry} {mode} {n}: {t:.4f} ms (turns {times[n][0]:.4f}, "
                      f"{times[n][1]:.4f}), {t / base:.3f} of committed; "
                      f"{frame.starts.shape[0]} tiles, {n_inst} instances; {card}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
