"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Each kernel source is compiled with nvcc for sm_90a into a shared library
with a plain C interface, at its first launch, into `_build/` beside this
file (listed in .gitignore), and loaded with ctypes (`load_all` builds
every source at once, one nvcc each). A library is named by the hash of its
source, so an edited kernel is rebuilt. Importing this
module needs neither nvcc nor a GPU: nothing is built or loaded until a
kernel is launched on a CUDA tensor.

`launches` counts the launches of each kernel; a wrapper adds one where it
launches its kernel and nowhere else, so a caller can show which kernels a
run went through (reset it with `reset_launches`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
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

launches: dict[str, int] = {"composite_fwd": 0, "composite_bwd": 0}
build_logs: dict[str, str] = {}  # kernel name -> nvcc's output (ptxas usage)
_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # data, gid, starts, stops, accum, tfinal, bestidx, capacity, num_tiles,
    # grid_x, tile_x, tile_y, track_idx, stream
    "composite_fwd": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _P],
    # data, starts, stops, gacc, acdot, gend, tfinal, dgrad, capacity, num_tiles,
    # grid_x, tile_x, tile_y, stream
    "composite_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P],
}
_locks = {name: threading.Lock() for name in _SIGNATURES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
                       "the CUDA kernels are built from csrc/ at first use")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built from csrc/<name>.cu if no
    library of this source exists yet."""
    with _locks[name]:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            build_logs[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src}:\n{build_logs[name]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def load_all() -> None:
    """load() every kernel, one thread (and so one nvcc) per source, all
    started together; raises the first build failure."""
    with ThreadPoolExecutor(len(_SIGNATURES)) as pool:
        list(pool.map(load, _SIGNATURES))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def composite_fwd(data: torch.Tensor, gid: torch.Tensor, starts: torch.Tensor,
                  stops: torch.Tensor, *, grid_x: int, tile_x: int, tile_y: int,
                  track_idx: bool):
    """Launch csrc/composite_fwd.cu on CUDA tensors: data f32 [16, capacity],
    gid i32 [capacity], starts/stops i32 [T]. Returns (accum f32 [T, P, 8],
    tfinal f32 [T, P, 1], bestidx i32 [T, P, 1]) with P = tile_x * tile_y,
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
    lib = load("composite_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.composite_fwd(data.data_ptr(), gid.data_ptr(), starts.data_ptr(),
                                stops.data_ptr(), accum.data_ptr(), tfinal.data_ptr(),
                                bestidx.data_ptr(), capacity, num_tiles, grid_x, tile_x,
                                tile_y, int(track_idx), stream)
    if err != 0:
        msg = lib.composite_fwd_error_string(err).decode()
        raise RuntimeError(f"composite_fwd launch failed: CUDA error {err} ({msg})")
    launches["composite_fwd"] += 1
    return accum, tfinal, bestidx


def composite_bwd(data: torch.Tensor, starts: torch.Tensor, stops: torch.Tensor,
                  gacc: torch.Tensor, acdot: torch.Tensor, gend: torch.Tensor,
                  tfinal: torch.Tensor, *, grid_x: int, tile_x: int, tile_y: int):
    """Launch csrc/composite_bwd.cu on CUDA tensors: data f32 [16, capacity],
    starts/stops i32 [T], gacc f32 [T, P, 8], acdot/gend/tfinal f32
    [T, P, 1]. Returns dgrad f32 [16, capacity] (zero outside every tile's
    range), computed on the current stream. Raises on anything the kernel
    does not take, and when the launch fails."""
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
    lib = load("composite_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.composite_bwd(data.data_ptr(), starts.data_ptr(), stops.data_ptr(),
                                gacc.data_ptr(), acdot.data_ptr(), gend.data_ptr(),
                                tfinal.data_ptr(), dgrad.data_ptr(), capacity, num_tiles,
                                grid_x, tile_x, tile_y, stream)
    if err != 0:
        msg = lib.composite_bwd_error_string(err).decode()
        raise RuntimeError(f"composite_bwd launch failed: CUDA error {err} ({msg})")
    launches["composite_bwd"] += 1
    return dgrad
