"""Probe P1: copying [16, 256] windows of f32[16, N] from aligned and from
arbitrary starts.

The counterpart of tools/tpu_probes/_tpu_unaligned.py. On the TPU the
question was whether a DMA could start a window at any lane offset; here it
is how fast a block stages a tile's instance rows of data[16, capacity] from
the tile's own, arbitrary start, as kernels A and B do. The kernel is
csrc/probe_unaligned.cu (`kernels.probe_unaligned`); `copy_windows_plain`
is its plain version.

    python -m ex4dgs_tpu_torch.probes.unaligned [--device cpu]
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from .. import kernels, resolve_device
from . import device_arg, readings_ms

N = 1 << 20
ROWS, G = kernels.PROBE_ROWS, kernels.PROBE_WINDOW
T = 4096
CHECKED_WINDOW = 7  # the window the TPU probe compares with numpy


def copy_windows_plain(src: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """out[p] = src[:, offsets[p] : offsets[p] + 256], as f32 [T, 16, 256].
    A gather of the windows' columns: `index_select` on `src.unfold(1, 256,
    1)` computes the same, but on the CPU it first copies the whole unfolded
    view (256 times src)."""
    cols = offsets.long()[:, None] + torch.arange(G, device=src.device)
    return src[:, cols].transpose(0, 1).contiguous()


def copy_windows(src: torch.Tensor, offsets: torch.Tensor, *,
                 check_range: bool = True) -> torch.Tensor:
    """The kernel on CUDA tensors (`kernels.probe_unaligned`, which takes
    `check_range`), the plain version on CPU tensors."""
    if src.device.type == "cpu":
        return copy_windows_plain(src, offsets)
    return kernels.probe_unaligned(src, offsets, check_range=check_range)


def make_src(n: int = N, device=None) -> torch.Tensor:
    """The TPU probe's source: seed 0, standard normal, f32 [16, n], on
    `device` (cuda unless told cpu)."""
    dev = resolve_device(device)
    src = np.random.default_rng(0).normal(size=(ROWS, n)).astype(np.float32)
    return torch.from_numpy(src).to(dev)


def offset_sets(n: int = N, t: int = T) -> dict[str, np.ndarray]:
    """The TPU probe's two sets of t window starts, drawn from seed 1 in its
    order: multiples of 256, then arbitrary integers."""
    rng = np.random.default_rng(1)
    aligned = (rng.integers(0, (n - G) // 256, t) * 256).astype(np.int32)
    unaligned = rng.integers(0, n - G, t).astype(np.int32)
    return {"aligned-256": aligned, "unaligned": unaligned}


def window_bytes(offsets: torch.Tensor) -> int:
    """The bytes a copy of these windows must move: every column that some
    window covers read once (windows that overlap share their reads), every
    window written once."""
    o = torch.unique(offsets.long())
    covered = int(torch.diff(o).clamp_max(G).sum().item()) + G if o.numel() else 0
    return 4 * ROWS * covered + 4 * ROWS * G * offsets.numel()


def run(device, n: int = N, t: int = T, reps: int = 20) -> dict[str, list[float]]:
    """Both offset sets through `copy_windows` on `device`: one call, whose
    offsets the wrapper range-checks, compared with src at one window as the
    TPU probe compares it, then `reps` calls timed (`readings_ms`) without
    the range check's wait for the device. Returns the readings per set."""
    dev = torch.device(device)
    src = make_src(n, dev)
    readings = {}
    for label, offs in offset_sets(n, t).items():
        o = torch.from_numpy(offs).to(dev)
        out = copy_windows(src, o)
        w = min(CHECKED_WINDOW, t - 1)
        if not torch.equal(out[w], src[:, int(offs[w]):int(offs[w]) + G]):
            raise RuntimeError(f"{label}: window {w} differs from src")
        readings[label] = readings_ms(lambda: copy_windows(src, o, check_range=False), dev,
                                      reps)
    return readings


def main(device=None, **sizes) -> dict[str, list[float]]:
    """Run the probe on `device` (cuda unless told cpu) and print the TPU
    probe's lines, with the median time of each set."""
    dev = resolve_device(device)
    readings = run(dev, **sizes)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu, plain version"
    for label, ms in readings.items():
        print(f"{label}: {statistics.median(ms):.4f} ms (median of {len(ms)}; {where})",
              flush=True)
    return readings


if __name__ == "__main__":
    main(device_arg())
