"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Each kernel source is compiled with nvcc for sm_90a into a shared library
with a plain C interface, at its first launch, into `_build/` beside this
file (listed in .gitignore), and loaded with ctypes (`load_all` builds
every source at once, one nvcc each). A source exports one C function per
entry point (`SOURCES`). A library is named by the hash of its source, of
every header (`*.cuh`) in the source's directory and of the nvcc flags, so
an edited kernel, or an edited header it may include, is rebuilt. Importing this module needs neither nvcc nor
a GPU: nothing is built or loaded until a kernel is launched on a CUDA
tensor.

`launches` counts the launches of each entry point; a wrapper adds one where
it launches its kernel and nowhere else, so a caller can show which kernels
a run went through (reset it with `reset_launches`). A launch that a CUDA
graph captures runs only when the graph is replayed, so it is counted then:
the capture's launches go to the tally of `capturing()`, and `replayed`
adds that tally once per replay. `graph_calls` counts, per device, how
`train_step` ran: eagerly, by a capture, and by a replay of its graph (a
capture's call replays the graph too); `reset_graph_calls` clears it.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# csrc/<source>.cu -> the C functions it exports, each launching one kernel
# (pack_vjp two: the cotangents put in expansion order, then the segment sums).
SOURCES = {
    "composite_fwd": ("composite_fwd",),
    "composite_bwd": ("composite_bwd",),
    "probe_unaligned": ("probe_unaligned",),
    "probe_outspec": ("outspec_a", "outspec_b", "outspec_c", "outspec_d", "outspec_e"),
    "slice4d_fwd": ("slice4d_fwd",),
    "slice4d_bwd": ("slice4d_bwd",),
    "pack_vjp": ("pack_vjp",),
}
launches: dict[str, int] = {fn: 0 for fns in SOURCES.values() for fn in fns}
_tallies: list[dict[str, int]] = []  # launches of the graphs being captured
graph_calls: dict[str, dict[str, int]] = {}  # device -> {"eager", "captures", "replays"}
build_logs: dict[str, str] = {}  # source name -> nvcc's output (ptxas usage)
_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # data, gid, starts, stops, offsets, accum, tfinal, bestidx, capacity,
    # num_tiles, tile0, grid_x, tile_x, tile_y, track_idx, stream
    "composite_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I,
                      _I, _P],
    # data, starts, stops, offsets, gacc, acdot, gend, tfinal, dgrad, capacity,
    # num_tiles, tile0, grid_x, tile_x, tile_y, stream
    "composite_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                      _I, _P],
    # src, offsets, out, n, num_windows, stream
    "probe_unaligned": [_P, _P, _P, ctypes.c_longlong, _I, _P],
    "outspec_a": [_P, _P, _P, _I, _P],  # accum, tfinal, bestidx, num_tiles, stream
    "outspec_b": [_P, _I, _P],  # out, num_tiles, stream
    "outspec_c": [_P, _I, _P],  # accum, num_tiles, stream
    "outspec_d": [_P, _P, _P, _P, _P, _I, _P],  # gacc, a1, a2, a3, out, num_tiles, stream
    "outspec_e": [_P, _P, _I, _P],  # gin, out, num_tiles, stream
    # 9 params, mask, t, campos, degree, degree_t, P, bands, span, mean, cov,
    # alpha, rgb, live, stream
    "slice4d_fwd": [_P] * 14 + [ctypes.c_longlong, _I, ctypes.c_float] + [_P] * 6,
    # 9 params, t, campos, degree, degree_t, 4 cotangents, P, bands, span,
    # 9 gradients, stream
    "slice4d_bwd": [_P] * 17 + [ctypes.c_longlong, _I, ctypes.c_float] + [_P] * 10,
    # ct, slot, cum, counts, by_slot, d_rows, capacity, P, stream
    "pack_vjp": [_P] * 6 + [ctypes.c_longlong, ctypes.c_longlong, _P],
}
_locks = {name: threading.Lock() for name in SOURCES}

# The probes' fixed shapes (tools/tpu_probes/_tpu_unaligned.py, _tpu_outspec.py).
PROBE_ROWS, PROBE_WINDOW = 16, 256
OUTSPEC_PIX = 512


_C_TYPES = {"const void*": _P, "void*": _P, "long long": ctypes.c_longlong, "int": _I,
            "float": ctypes.c_float}


def declared_signature(source: str, entry: str) -> list[tuple[str, object]]:
    """[(parameter name, ctypes type)] of C function `entry` as the
    `extern "C" int entry(...)` declaration in the text of a csrc source
    declares it, so that a caller can pass arguments by name to any
    revision of the source."""
    m = re.search(r'extern "C" int ' + re.escape(entry) + r"\(([^)]*)\)", source)
    if m is None:
        raise ValueError(f'no extern "C" int {entry}(...) in the source')
    params = []
    for decl in m.group(1).split(","):
        ctype, name = re.fullmatch(r"\s*(.*?)\s*(\w+)\s*", decl).groups()
        params.append((name, _C_TYPES[" ".join(ctype.replace("*", "* ").split()).rstrip()]))
    return params


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count_launch(entry: str, captured: bool) -> None:
    """One launch of `entry`: into `launches`, or, when a CUDA graph captured
    it (it did not run), into the tally of the capture under way."""
    if captured and _tallies:
        _tallies[-1][entry] += 1
    else:
        launches[entry] += 1


@contextlib.contextmanager
def capturing():
    """Around the capture of a CUDA graph: yields the tally (entry point ->
    launches) that the captured launches go to, for `replayed`."""
    tally = dict.fromkeys(launches, 0)
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.remove(tally)


def replayed(tally: dict[str, int]) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    `tally`."""
    for name, n in tally.items():
        launches[name] += n


def _device_name(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def graph_call_counts(device) -> dict[str, int]:
    """A copy of `graph_calls` of `device` (zeros where none ran)."""
    return dict(graph_calls.get(_device_name(device), {"eager": 0, "captures": 0, "replays": 0}))


def count_graph_call(device, kind: str) -> None:
    """One train_step on `device` that ran `kind`: "eager", "captures" or
    "replays"."""
    calls = graph_calls.setdefault(_device_name(device),
                                   {"eager": 0, "captures": 0, "replays": 0})
    calls[kind] += 1


def reset_graph_calls() -> None:
    graph_calls.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
                       "the CUDA kernels are built from csrc/ at first use")


def source_digest(src: Path) -> str:
    """The hash that names src's library: src, every csrc-style header
    (`*.cuh`) beside it, by name and content, and the nvcc flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build(src: Path, out_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """(library path, nvcc's output) of source `src`, compiled into out_dir
    unless a library of the same digest is there already ("" then)."""
    out = out_dir / f"lib{src.stem}_{source_digest(src)[:16]}.so"
    if out.exists():
        return out, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{text}")
    os.replace(tmp, out)
    return out, text


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built from csrc/<name>.cu if no
    library of this source (and of the headers beside it) exists yet."""
    with _locks[name]:
        if name in _libs:
            return _libs[name]
        path, text = build(CSRC / f"{name}.cu")
        if text:
            build_logs[name] = text
        lib = ctypes.CDLL(str(path))
        for entry in SOURCES[name]:
            fn = getattr(lib, entry)
            fn.argtypes = _SIGNATURES[entry]
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def load_all() -> None:
    """load() every source, one thread (and so one nvcc) per source, all
    started together; raises the first build failure."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(load, SOURCES))


def _launch(source: str, entry: str, dev: torch.device, *args) -> None:
    """Call C function `entry` of csrc/<source>.cu with `args` and the
    current stream of `dev`; raise if the launch failed, else count it
    (`count_launch`)."""
    lib = load(source)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        captured = torch.cuda.is_current_stream_capturing()
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        msg = getattr(lib, f"{source}_error_string")(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")
    count_launch(entry, captured)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tile0(tile0: int, num_tiles: int) -> None:
    """tile0 must be a non-negative int whose last tile fits an int."""
    if not isinstance(tile0, int) or tile0 < 0 or tile0 + num_tiles >= 2**31:
        raise ValueError(f"tile0 must be an int in [0, 2^31 - T), got {tile0!r}")


def _offsets_ptr(offsets, num_tiles: int, npix: int, dev):
    """The subpixel offsets' pointer (None: the kernel's null path) after
    checking them: f32 [T, P, 2], contiguous, on dev."""
    if offsets is None:
        return None
    _check("offsets", offsets, torch.float32, (num_tiles, npix, 2), dev)
    return offsets.data_ptr()


def composite_fwd(data: torch.Tensor, gid: torch.Tensor, starts: torch.Tensor,
                  stops: torch.Tensor, *, grid_x: int, tile_x: int, tile_y: int,
                  track_idx: bool, offsets: torch.Tensor | None = None, tile0: int = 0):
    """Launch csrc/composite_fwd.cu on CUDA tensors: data f32 [16, capacity],
    gid i32 [capacity], starts/stops i32 [T], and optionally the per-pixel
    subpixel offsets f32 [T, P, 2]. Tile t is the grid's tile tile0 + t
    (a scalar: the JAX kernel's tile ids are always arange or t0 + arange).
    Returns (accum f32 [T, P, 8], tfinal f32 [T, P, 1], bestidx i32
    [T, P, 1]) with P = tile_x * tile_y, computed on the current stream.
    Raises on anything the kernel does not take, and when the launch
    fails."""
    dev = data.device
    capacity = data.shape[1] if data.dim() == 2 else -1
    num_tiles = starts.shape[0] if starts.dim() == 1 else -1
    npix = tile_x * tile_y
    _check("data", data, torch.float32, (16, capacity), dev)
    _check("gid", gid, torch.int32, (capacity,), dev)
    _check("starts", starts, torch.int32, (num_tiles,), dev)
    _check("stops", stops, torch.int32, (num_tiles,), dev)
    off = _offsets_ptr(offsets, num_tiles, npix, dev)
    if not (0 < npix <= 1024 and npix % 32 == 0):
        raise ValueError(f"tile {tile_x}x{tile_y}: one thread per pixel needs an area "
                         "that is a multiple of 32 and at most 1024")
    _check_tile0(tile0, num_tiles)
    if dev.type != "cuda":
        raise ValueError(f"composite_fwd runs on CUDA tensors, got {dev}")
    accum = torch.empty((num_tiles, npix, 8), dtype=torch.float32, device=dev)
    tfinal = torch.empty((num_tiles, npix, 1), dtype=torch.float32, device=dev)
    bestidx = torch.empty((num_tiles, npix, 1), dtype=torch.int32, device=dev)
    if num_tiles == 0:
        return accum, tfinal, bestidx
    _launch("composite_fwd", "composite_fwd", dev, data.data_ptr(), gid.data_ptr(),
            starts.data_ptr(), stops.data_ptr(), off, accum.data_ptr(), tfinal.data_ptr(),
            bestidx.data_ptr(), capacity, num_tiles, tile0, grid_x, tile_x, tile_y,
            int(track_idx))
    return accum, tfinal, bestidx


def composite_bwd(data: torch.Tensor, starts: torch.Tensor, stops: torch.Tensor,
                  gacc: torch.Tensor, acdot: torch.Tensor, gend: torch.Tensor,
                  tfinal: torch.Tensor, *, grid_x: int, tile_x: int, tile_y: int,
                  offsets: torch.Tensor | None = None, tile0: int = 0):
    """Launch csrc/composite_bwd.cu on CUDA tensors: data f32 [16, capacity],
    starts/stops i32 [T], gacc f32 [T, P, 8], acdot/gend/tfinal f32
    [T, P, 1], optionally the forward's subpixel offsets f32 [T, P, 2], and
    the forward's tile0 (tile t is the grid's tile tile0 + t).
    Returns dgrad f32 [16, capacity] (zero outside every tile's range),
    computed on the current stream. Raises on anything the kernel does not
    take, and when the launch fails."""
    dev = data.device
    capacity = data.shape[1] if data.dim() == 2 else -1
    num_tiles = starts.shape[0] if starts.dim() == 1 else -1
    npix = tile_x * tile_y
    _check("data", data, torch.float32, (16, capacity), dev)
    _check("starts", starts, torch.int32, (num_tiles,), dev)
    _check("stops", stops, torch.int32, (num_tiles,), dev)
    _check("gacc", gacc, torch.float32, (num_tiles, npix, 8), dev)
    for name, t in (("acdot", acdot), ("gend", gend), ("tfinal", tfinal)):
        _check(name, t, torch.float32, (num_tiles, npix, 1), dev)
    off = _offsets_ptr(offsets, num_tiles, npix, dev)
    if not (0 < npix <= 1024 and npix % 32 == 0):
        raise ValueError(f"tile {tile_x}x{tile_y}: one thread per pixel needs an area "
                         "that is a multiple of 32 and at most 1024")
    _check_tile0(tile0, num_tiles)
    if dev.type != "cuda":
        raise ValueError(f"composite_bwd runs on CUDA tensors, got {dev}")
    # Zero-filled here: the kernel writes only the instances its tiles walk
    # before every pixel latches.
    dgrad = torch.zeros((16, capacity), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return dgrad
    _launch("composite_bwd", "composite_bwd", dev, data.data_ptr(), starts.data_ptr(),
            stops.data_ptr(), off, gacc.data_ptr(), acdot.data_ptr(), gend.data_ptr(),
            tfinal.data_ptr(), dgrad.data_ptr(), capacity, num_tiles, tile0, grid_x, tile_x,
            tile_y)
    return dgrad


def probe_unaligned(src: torch.Tensor, offsets: torch.Tensor, *,
                    check_range: bool = True) -> torch.Tensor:
    """Launch csrc/probe_unaligned.cu on CUDA tensors: src f32 [16, N],
    offsets i32 [T], each in [0, N - 256]. Returns out f32 [T, 16, 256],
    out[p] = src[:, offsets[p] : offsets[p] + 256], computed on the current
    stream. Raises on anything the kernel does not take, and when the launch
    fails. The range check reads the offsets to the host and so waits for
    the device; a caller that times launches of offsets it has checked
    already passes check_range=False."""
    dev = src.device
    n = src.shape[1] if src.dim() == 2 else -1
    num = offsets.shape[0] if offsets.dim() == 1 else -1
    _check("src", src, torch.float32, (PROBE_ROWS, n), dev)
    _check("offsets", offsets, torch.int32, (num,), dev)
    if n < PROBE_WINDOW:
        raise ValueError(f"src has {n} columns, fewer than one {PROBE_WINDOW}-wide window")
    if check_range and num and not (int(offsets.min()) >= 0
                                    and int(offsets.max()) <= n - PROBE_WINDOW):
        raise ValueError(f"an offset lies outside [0, {n - PROBE_WINDOW}]: the window "
                         f"would read past src")
    if dev.type != "cuda":
        raise ValueError(f"probe_unaligned runs on CUDA tensors, got {dev}")
    out = torch.empty((num, PROBE_ROWS, PROBE_WINDOW), dtype=torch.float32, device=dev)
    if num == 0:
        return out
    _launch("probe_unaligned", "probe_unaligned", dev, src.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), n, num)
    return out


def _outspec_device(num_tiles: int, device) -> torch.device:
    dev = torch.device(device)
    if num_tiles <= 0:
        raise ValueError(f"num_tiles must be positive, got {num_tiles}")
    if dev.type != "cuda":
        raise ValueError(f"the outspec probes run on a CUDA device, got {dev}")
    return dev


def outspec_a(num_tiles: int, device="cuda"):
    """Launch probe_outspec.cu's kernel a: kernel A's output layout filled
    with constants. Returns (accum f32 [T, 512, 8] of 1.0, tfinal f32
    [T, 512, 1] of 2.0, bestidx i32 [T, 512, 1] of 3)."""
    dev = _outspec_device(num_tiles, device)
    accum = torch.empty((num_tiles, OUTSPEC_PIX, 8), dtype=torch.float32, device=dev)
    tfinal = torch.empty((num_tiles, OUTSPEC_PIX, 1), dtype=torch.float32, device=dev)
    bestidx = torch.empty((num_tiles, OUTSPEC_PIX, 1), dtype=torch.int32, device=dev)
    _launch("probe_outspec", "outspec_a", dev, accum.data_ptr(), tfinal.data_ptr(),
            bestidx.data_ptr(), num_tiles)
    return accum, tfinal, bestidx


def outspec_b(num_tiles: int, device="cuda") -> torch.Tensor:
    """Kernel b: the wide, channel-major layout f32 [T, 16, 512] filled with
    1.0 by 16-byte stores."""
    dev = _outspec_device(num_tiles, device)
    out = torch.empty((num_tiles, 16, OUTSPEC_PIX), dtype=torch.float32, device=dev)
    _launch("probe_outspec", "outspec_b", dev, out.data_ptr(), num_tiles)
    return out


def outspec_c(num_tiles: int, device="cuda") -> torch.Tensor:
    """Kernel c: accum alone, f32 [T, 512, 8] filled with 1.0."""
    dev = _outspec_device(num_tiles, device)
    out = torch.empty((num_tiles, OUTSPEC_PIX, 8), dtype=torch.float32, device=dev)
    _launch("probe_outspec", "outspec_c", dev, out.data_ptr(), num_tiles)
    return out


def outspec_d(gacc: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
              a3: torch.Tensor) -> torch.Tensor:
    """Kernel d: kernel B's input layout, gacc f32 [T, 512, 8] and a1, a2, a3
    f32 [T, 512, 1], read in; returns f32 [T, 16, 512] holding, everywhere
    in tile t, the sum of tile t's inputs."""
    dev = gacc.device
    num_tiles = gacc.shape[0] if gacc.dim() == 3 else -1
    _check("gacc", gacc, torch.float32, (num_tiles, OUTSPEC_PIX, 8), dev)
    for name, t in (("a1", a1), ("a2", a2), ("a3", a3)):
        _check(name, t, torch.float32, (num_tiles, OUTSPEC_PIX, 1), dev)
    dev = _outspec_device(num_tiles, dev)
    out = torch.empty((num_tiles, 16, OUTSPEC_PIX), dtype=torch.float32, device=dev)
    _launch("probe_outspec", "outspec_d", dev, gacc.data_ptr(), a1.data_ptr(), a2.data_ptr(),
            a3.data_ptr(), out.data_ptr(), num_tiles)
    return out


def outspec_e(gin: torch.Tensor) -> torch.Tensor:
    """Kernel e: gin f32 [T, 16, 512] read in; returns f32 [T, 16, 512]
    holding, everywhere in tile t, the sum of gin[t]."""
    dev = gin.device
    num_tiles = gin.shape[0] if gin.dim() == 3 else -1
    _check("gin", gin, torch.float32, (num_tiles, 16, OUTSPEC_PIX), dev)
    dev = _outspec_device(num_tiles, dev)
    out = torch.empty((num_tiles, 16, OUTSPEC_PIX), dtype=torch.float32, device=dev)
    _launch("probe_outspec", "outspec_e", dev, gin.data_ptr(), out.data_ptr(), num_tiles)
    return out


def _slice4d_inputs(params, t, campos, degree, degree_t):
    """Check the slicing kernels' common inputs: the nine parameters
    (xyz [P, 3], t [P, 1], scaling [P, 3], scaling_t [P, 1], rotation and
    rotation_r [P, 4], opacity [P, 1], f_dc [P, 1, 3], f_rest [P, 16 B - 1,
    3] for B time bands, 1 to 3) in float32 on one CUDA device, contiguous,
    the quaternions 16-byte aligned; t f32 [], campos f32 [3], the degrees
    i32 []. Returns (device, P, bands)."""
    dev = params[0].device
    P = params[0].shape[0] if params[0].dim() == 2 else -1
    rows = params[8].shape[1] + 1 if params[8].dim() == 3 else -1
    if rows % 16 or not 1 <= rows // 16 <= 3:
        raise ValueError(f"f_rest has {rows - 1} rows; the kernels take 16 B - 1 for B in 1..3")
    shapes = ((P, 3), (P, 1), (P, 3), (P, 1), (P, 4), (P, 4), (P, 1), (P, 1, 3), (P, rows - 1, 3))
    for name, x, shape in zip(("xyz", "t", "scaling", "scaling_t", "rotation", "rotation_r",
                               "opacity", "f_dc", "f_rest"), params, shapes):
        _check(name, x, torch.float32, shape, dev)
    for name, x in (("rotation", params[4]), ("rotation_r", params[5])):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (one float4 a Gaussian)")
    _check("t (time)", t, torch.float32, (), dev)
    _check("campos", campos, torch.float32, (3,), dev)
    _check("degree", degree, torch.int32, (), dev)
    _check("degree_t", degree_t, torch.int32, (), dev)
    if dev.type != "cuda":
        raise ValueError(f"the slicing kernels run on CUDA tensors, got {dev}")
    return dev, P, rows // 16


def slice4d_fwd(*args, span: float):
    """Launch csrc/slice4d_fwd.cu: args are the nine parameters (see
    `_slice4d_inputs`), mask bool [P], t, campos, degree, degree_t. Returns
    (mean f32 [P, 3], cov3d f32 [P, 6], alpha f32 [P], rgb f32 [P, 3], live
    bool [P]), computed on the current stream (ops/slice4d.py has the
    equations). Raises on anything the kernel does not take, and when the
    launch fails."""
    params, (mask, t, campos, degree, degree_t) = args[:9], args[9:]
    dev, P, bands = _slice4d_inputs(params, t, campos, degree, degree_t)
    _check("mask", mask, torch.bool, (P,), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty((P, 3), **f32), torch.empty((P, 6), **f32), torch.empty((P,), **f32),
           torch.empty((P, 3), **f32), torch.empty((P,), dtype=torch.bool, device=dev))
    if P == 0:
        return out
    _launch("slice4d_fwd", "slice4d_fwd", dev, *(x.data_ptr() for x in params), mask.data_ptr(),
            t.data_ptr(), campos.data_ptr(), degree.data_ptr(), degree_t.data_ptr(), P, bands,
            float(span), *(x.data_ptr() for x in out))
    return out


def slice4d_bwd(*args, span: float):
    """Launch csrc/slice4d_bwd.cu: args are the nine parameters, t, campos,
    degree, degree_t and the cotangents of mean f32 [P, 3], cov3d [P, 6],
    alpha [P] and rgb [P, 3]. Returns the nine parameters' gradients, shaped
    as they are, computed on the current stream."""
    params, (t, campos, degree, degree_t), cots = args[:9], args[9:13], args[13:]
    dev, P, bands = _slice4d_inputs(params, t, campos, degree, degree_t)
    for name, x, shape in zip(("g_mean", "g_cov", "g_alpha", "g_rgb"), cots,
                              ((P, 3), (P, 6), (P,), (P, 3))):
        _check(name, x, torch.float32, shape, dev)
    grads = tuple(torch.empty_like(x, memory_format=torch.contiguous_format) for x in params)
    if P == 0:
        return grads
    _launch("slice4d_bwd", "slice4d_bwd", dev, *(x.data_ptr() for x in params), t.data_ptr(),
            campos.data_ptr(), degree.data_ptr(), degree_t.data_ptr(),
            *(x.data_ptr() for x in cots), P, bands, float(span),
            *(x.data_ptr() for x in grads))
    return grads


def pack_vjp(ct: torch.Tensor, slot: torch.Tensor, cum: torch.Tensor,
             counts: torch.Tensor) -> torch.Tensor:
    """Launch csrc/pack_vjp.cu on CUDA tensors: the cotangent ct f32
    [16, capacity] of the packed buffer, slot i32 [capacity] (Binning.slot),
    cum and counts i32 [P] (Binning.cum, Binning.counts). Returns d_rows f32
    [16, P], each Gaussian's sum of its instances' cotangent columns
    (ops/rasterize_cuda.py::pack_vjp_plain gives the same bits), computed
    on the current stream. Raises on anything the kernel does not take, and
    when the launch fails."""
    dev = ct.device
    capacity = ct.shape[1] if ct.dim() == 2 else -1
    P = cum.shape[0] if cum.dim() == 1 else -1
    _check("ct", ct, torch.float32, (16, capacity), dev)
    _check("slot", slot, torch.int32, (capacity,), dev)
    _check("cum", cum, torch.int32, (P,), dev)
    _check("counts", counts, torch.int32, (P,), dev)
    if capacity >= 2**31:
        raise ValueError(f"capacity {capacity}: the kernel's slots are int32")
    if dev.type != "cuda":
        raise ValueError(f"pack_vjp runs on CUDA tensors, got {dev}")
    # the live instances' cotangent rows in expansion order (scratch)
    by_slot = torch.empty((capacity, 16), dtype=torch.float32, device=dev)
    d_rows = torch.empty((16, P), dtype=torch.float32, device=dev)
    if P == 0 or capacity == 0:
        return d_rows.zero_()
    _launch("pack_vjp", "pack_vjp", dev, ct.data_ptr(), slot.data_ptr(), cum.data_ptr(),
            counts.data_ptr(), by_slot.data_ptr(), d_rows.data_ptr(), capacity, P)
    return d_rows
