"""ex4dgs_tpu_torch — the PyTorch/CUDA port of ex4dgs_tpu.

Same model, same outputs, same capacity-padded state layout as the JAX
package, written for an NVIDIA Hopper GPU: plain tensor code is PyTorch, and
the Pallas TPU kernels become hand-written CUDA kernels (`csrc/`, built at
first use by `kernels.py`). The module tree mirrors the JAX package, so each
counterpart is found by path:

  ops/        math3d, interpolation, knn, projection, binning, compositing,
              rasterize_tiled (the portable oracle), rasterize_cuda (the
              compositing kernels' wrappers, their plain versions and the
              autograd functions), losses
  models/     config, capacity-padded Gaussian state, temporal queries,
              the RAdam optimizer, density control (host numpy events,
              pull/push)
  data/       COLMAP readers, the N3V/Technicolor/COLMAP scene readers,
              cameras, Scene and the image prefetcher with its device cache
  io/         PLY, model PLY and checkpoint files (either package's)
  rendering   the public render API
  train/      the training step, the Trainer, and the training CLI
              (`python -m ex4dgs_tpu_torch.train`)
  synthetic   synthetic scenes and cameras
  probes/     the layout probes of tools/tpu_probes/ (P1 `unaligned`, P2
              `outspec`), their kernels' plain versions and entry points
  bench_frame the bench scene and frame the kernels are measured on, and
              a seeded on-disk N3V scene; kernel_turns times either
              compositing kernel against other builds of it

Entry points put their tensors on `cuda` unless the caller passes
`device="cpu"`; without a GPU they raise instead of falling back.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

# Full-f32 matmuls and convolutions. TF32 keeps ~10 mantissa bits; the JAX
# package pins the same policy (its f32 "highest" matmul default) after
# reduced-precision products sent training to NaN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point works on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    none is present — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ex4dgs_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain CPU path")
    return dev


def scalar_on(x, device, dtype=torch.float32) -> torch.Tensor:
    """x as a 0-d tensor of `dtype` on `device`. A host number is filled in
    there by a kernel, with no copy from the host; a tensor goes through
    `upload` (or stays where it is)."""
    if isinstance(x, torch.Tensor):
        return upload(x, device, dtype)
    return torch.full((), x, dtype=dtype, device=device)


def upload(x, device, dtype=None, out=None) -> torch.Tensor:
    """x (a number, a numpy array or a tensor) as a tensor on `device`, or
    copied into `out` (a tensor there) when given. A host array bound for a
    CUDA device is staged in pinned memory and copied without blocking: a
    copy from pageable memory makes the host wait until the device's stream
    has drained."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        t = t.pin_memory()
        return t.to(device, non_blocking=True) if out is None else out.copy_(t, non_blocking=True)
    return t.to(device) if out is None else out.copy_(t)
