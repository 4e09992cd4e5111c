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
              the RAdam optimizer
  rendering   the public render API
  train/      the training step
  synthetic   synthetic scenes and cameras
  probes/     the layout probes of tools/tpu_probes/ (P1 `unaligned`, P2
              `outspec`), their kernels' plain versions and entry points

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
