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
a run went through (reset it with `reset_launches`).
"""
from __future__ import annotations

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

# csrc/<source>.cu -> the C functions it exports, each launching one kernel.
SOURCES = {
    "composite_fwd": ("composite_fwd",),
    "composite_bwd": ("composite_bwd",),
    "probe_unaligned": ("probe_unaligned",),
    "probe_outspec": ("outspec_a", "outspec_b", "outspec_c", "outspec_d", "outspec_e"),
}
launches: dict[str, int] = {fn: 0 for fns in SOURCES.values() for fn in fns}
build_logs: dict[str, str] = {}  # source name -> nvcc's output (ptxas usage)
_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # data, gid, starts, stops, offsets, accum, tfinal, bestidx, capacity,
    # num_tiles, grid_x, tile_x, tile_y, track_idx, stream
    "composite_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I,
                      _P],
    # data, starts, stops, offsets, gacc, acdot, gend, tfinal, dgrad, capacity,
    # num_tiles, grid_x, tile_x, tile_y, stream
    "composite_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                      _P],
    # src, offsets, out, n, num_windows, stream
    "probe_unaligned": [_P, _P, _P, ctypes.c_longlong, _I, _P],
    "outspec_a": [_P, _P, _P, _I, _P],  # accum, tfinal, bestidx, num_tiles, stream
    "outspec_b": [_P, _I, _P],  # out, num_tiles, stream
    "outspec_c": [_P, _I, _P],  # accum, num_tiles, stream
    "outspec_d": [_P, _P, _P, _P, _P, _I, _P],  # gacc, a1, a2, a3, out, num_tiles, stream
    "outspec_e": [_P, _P, _I, _P],  # gin, out, num_tiles, stream
}
_locks = {name: threading.Lock() for name in SOURCES}

# The probes' fixed shapes (tools/tpu_probes/_tpu_unaligned.py, _tpu_outspec.py).
PROBE_ROWS, PROBE_WINDOW = 16, 256
OUTSPEC_PIX = 512


_C_TYPES = {"const void*": _P, "void*": _P, "long long": ctypes.c_longlong, "int": _I}


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
    current stream of `dev`; raise if the launch failed, else count it."""
    lib = load(source)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        msg = getattr(lib, f"{source}_error_string")(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")
    launches[entry] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _offsets_ptr(offsets, num_tiles: int, npix: int, dev):
    """The subpixel offsets' pointer (None: the kernel's null path) after
    checking them: f32 [T, P, 2], contiguous, on dev."""
    if offsets is None:
        return None
    _check("offsets", offsets, torch.float32, (num_tiles, npix, 2), dev)
    return offsets.data_ptr()


def composite_fwd(data: torch.Tensor, gid: torch.Tensor, starts: torch.Tensor,
                  stops: torch.Tensor, *, grid_x: int, tile_x: int, tile_y: int,
                  track_idx: bool, offsets: torch.Tensor | None = None):
    """Launch csrc/composite_fwd.cu on CUDA tensors: data f32 [16, capacity],
    gid i32 [capacity], starts/stops i32 [T], and optionally the per-pixel
    subpixel offsets f32 [T, P, 2]. Returns (accum f32 [T, P, 8], tfinal
    f32 [T, P, 1], bestidx i32 [T, P, 1]) with P = tile_x * tile_y,
    computed on the current stream. Raises on anything the kernel does not
    take, and when the launch fails."""
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
    if dev.type != "cuda":
        raise ValueError(f"composite_fwd runs on CUDA tensors, got {dev}")
    accum = torch.empty((num_tiles, npix, 8), dtype=torch.float32, device=dev)
    tfinal = torch.empty((num_tiles, npix, 1), dtype=torch.float32, device=dev)
    bestidx = torch.empty((num_tiles, npix, 1), dtype=torch.int32, device=dev)
    if num_tiles == 0:
        return accum, tfinal, bestidx
    _launch("composite_fwd", "composite_fwd", dev, data.data_ptr(), gid.data_ptr(),
            starts.data_ptr(), stops.data_ptr(), off, accum.data_ptr(), tfinal.data_ptr(),
            bestidx.data_ptr(), capacity, num_tiles, grid_x, tile_x, tile_y, int(track_idx))
    return accum, tfinal, bestidx


def composite_bwd(data: torch.Tensor, starts: torch.Tensor, stops: torch.Tensor,
                  gacc: torch.Tensor, acdot: torch.Tensor, gend: torch.Tensor,
                  tfinal: torch.Tensor, *, grid_x: int, tile_x: int, tile_y: int,
                  offsets: torch.Tensor | None = None):
    """Launch csrc/composite_bwd.cu on CUDA tensors: data f32 [16, capacity],
    starts/stops i32 [T], gacc f32 [T, P, 8], acdot/gend/tfinal f32
    [T, P, 1], and optionally the forward's subpixel offsets f32 [T, P, 2].
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
    if dev.type != "cuda":
        raise ValueError(f"composite_bwd runs on CUDA tensors, got {dev}")
    # Zero-filled here: the kernel writes only the instances its tiles walk
    # before every pixel latches.
    dgrad = torch.zeros((16, capacity), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return dgrad
    _launch("composite_bwd", "composite_bwd", dev, data.data_ptr(), starts.data_ptr(),
            stops.data_ptr(), off, gacc.data_ptr(), acdot.data_ptr(), gend.data_ptr(),
            tfinal.data_ptr(), dgrad.data_ptr(), capacity, num_tiles, grid_x, tile_x, tile_y)
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
    """Kernel b: the wide, channel-major layout f32 [T, 16, 512] filled with 1.0."""
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
