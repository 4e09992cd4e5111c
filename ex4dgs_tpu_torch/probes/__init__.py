"""Layout probes: the counterparts of the TPU probes in tools/tpu_probes/.

  unaligned   P1 (_tpu_unaligned.py): [16, 256] windows of f32[16, 2^20]
              copied from aligned and arbitrary starts (csrc/probe_unaligned.cu)
  outspec     P2 (_tpu_outspec.py): narrow per-pixel against wide
              channel-major per-tile blocks (csrc/probe_outspec.cu)

Each module holds the plain PyTorch versions of its kernels, a `run` at the
TPU probe's own shapes and a `main` that prints the TPU probe's labels:

    python -m ex4dgs_tpu_torch.probes.unaligned [--device cpu]
    python -m ex4dgs_tpu_torch.probes.outspec [--device cpu]

They run on `cuda` unless told `cpu` (the plain versions, timed on the
host clock), and raise where there is no CUDA device.
"""
from __future__ import annotations

import argparse
import time

import torch

FLUSH_BYTES = 512 * 2**20


def readings_ms(fn, device: torch.device, reps: int) -> list[float]:
    """Milliseconds of each of `reps` calls of fn(), after one untimed call.

    On a CUDA device each call is timed by its own pair of events. Before
    each pair a 512 MiB scratch tensor is written, outside the pair: the L2
    (50 MB on an H100) then holds nothing of the previous call, and the
    scratch's lines it does hold are dirty, so a call's writes make room by
    writing them back and cannot finish in L2 faster than the memory takes
    them. The scratch write also keeps the device busy while the host
    issues the call, so the pair usually times the call's device work and
    one launch's ramp; a host stall longer than the scratch write still
    lands inside the pair, so a caller takes the median. On the CPU: the
    host clock."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize(device)
    for i, (t0, t1) in enumerate(events):
        scratch.fill_(float(i))
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize(device)
    return [t0.elapsed_time(t1) for t0, t1 in events]


def device_arg(argv=None) -> str | None:
    """The --device of a probe's command line (None: cuda)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu for the plain versions")
    return parser.parse_args(argv).device
