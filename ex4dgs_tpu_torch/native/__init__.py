"""Native (C++) host image decode: a libpng thread pool bound with ctypes.

Counterpart of `ex4dgs_tpu/native/` with its API (`NativeImageLoader`:
`submit`, `wait`, `close`). `loader.cpp` beside this file is built with g++
(the JAX package's flags) at the first `NativeImageLoader()`, never at
import, into `_build/` of the package (listed in .gitignore), named by the
hash of the source, the flags and the CPU that `-march=native` resolves to
(a library built for one host must not load on another), as `kernels.py`
names its libraries. A machine without g++ or libpng gets a RuntimeError
there; the prefetcher (data/scene.py) then decodes with PIL and records
that it did.

The loader box-filters a resized frame (PIL, the eval path's decoder,
resamples with LANCZOS), so the two decoders differ wherever a frame is
resampled and is not flat.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
LINK_FLAGS = ("-lpng", "-pthread")
_lib = None
_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _native_arch() -> str:
    """The target g++ takes for -march=native here ("" without g++)."""
    try:
        out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True).stdout
    except FileNotFoundError:
        return ""
    m = re.search(r"^\s*-march=\s*(\S+)", out, re.M)
    return m.group(1) if m else ""


def library_path(src: Path = SRC, out_dir: Path = BUILD_DIR) -> Path:
    """Where the library of `src`, the flags and this host's CPU lives
    (built or not)."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS + LINK_FLAGS).encode() + b"\0" + _native_arch().encode())
    return out_dir / f"libloader_{h.hexdigest()[:16]}.so"


def build(src: Path = SRC, out_dir: Path = BUILD_DIR) -> Path:
    """The library of `src`, compiled with g++ unless one of the same
    digest exists; raises RuntimeError when g++ or libpng is missing."""
    out = library_path(src, out_dir)
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp), *LINK_FLAGS]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise RuntimeError(
            f"native loader build failed: {detail.decode(errors='replace') or e}") from e
    os.replace(tmp, out)
    return out


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.loader_create.restype = ctypes.c_void_p
            lib.loader_create.argtypes = [ctypes.c_int]
            lib.loader_destroy.argtypes = [ctypes.c_void_p]
            lib.loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_float, ctypes.c_int]
            lib.loader_wait.restype = ctypes.c_int
            lib.loader_wait.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]
            _lib = lib
        return _lib


class NativeImageLoader:
    """Ticketed asynchronous PNG decode and resize on a C++ thread pool:
    `submit` queues a frame and returns its ticket, `wait` returns it as
    f32 [height, width, 3] in [0, 1] (IOError if it failed to decode)."""

    def __init__(self, n_threads: int | None = None):
        self.lib = _get_lib()
        n = n_threads or max(2, (os.cpu_count() or 4) - 1)
        self.handle = ctypes.c_void_p(self.lib.loader_create(n))
        self._next_ticket = 0
        self._pending: dict[int, tuple[int, int]] = {}

    def submit(self, path: str, width: int, height: int, im_scale: float = 1.0) -> int:
        t = self._next_ticket
        self._next_ticket += 1
        self.lib.loader_submit(self.handle, path.encode(), width, height,
                               ctypes.c_float(im_scale), t)
        self._pending[t] = (width, height)
        return t

    def wait(self, ticket: int) -> np.ndarray:
        w, h = self._pending.pop(ticket)
        out = np.empty((h, w, 3), np.float32)
        rc = self.lib.loader_wait(self.handle, ticket,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
        if rc != 0:
            raise IOError(f"native decode failed (rc={rc}) for ticket {ticket}")
        return out

    def close(self) -> None:
        if self.handle:
            self.lib.loader_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
