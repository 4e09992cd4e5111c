"""Probe P2: narrow per-pixel against wide channel-major per-tile blocks.

The counterpart of tools/tpu_probes/_tpu_outspec.py, at its shapes (T =
2752 tiles of 512 pixels, the bench frame's 32x16 tiles at 1352x1014). Five
trivial kernels stream a tile's block in different layouts:

  a  out accum [T, 512, 8] + tfinal [T, 512, 1] + bestidx i32 [T, 512, 1]
     (kernel A's output layout)
  b  out [T, 16, 512]                            (wide, pixel axis minor)
  c  out accum [T, 512, 8] alone
  d  in  [T, 512, 8] + 3 x [T, 512, 1] -> out [T, 16, 512]
     (kernel B's input layout)
  e  in  [T, 16, 512]                  -> out [T, 16, 512]

The kernels are csrc/probe_outspec.cu (`kernels.outspec_a` ... `outspec_e`);
the `*_plain` functions are their plain versions.

    python -m ex4dgs_tpu_torch.probes.outspec [--device cpu]
"""
from __future__ import annotations

import statistics

import torch

from .. import kernels, resolve_device
from . import device_arg, readings_ms

T = 2752
N_PIX = kernels.OUTSPEC_PIX
LABELS = {"a": "A 3-out narrow (current fwd)", "b": "B 1-out wide [16,512]",
          "c": "C 1-out [512,8]", "d": "D 4-in narrow -> wide out (bwd-like)",
          "e": "E 1-in wide -> wide out"}
# The tile sums of d and e over the probe's all-ones inputs.
ONES_SUM = {"d": 8 * N_PIX + 3 * N_PIX, "e": 16 * N_PIX}
# The bytes each kernel must move per pixel: inputs read once, outputs
# written once.
BYTES_PER_PIXEL = {"a": 4 * (8 + 1 + 1), "b": 4 * 16, "c": 4 * 8, "d": 4 * (8 + 3) + 4 * 16,
                   "e": 4 * 16 + 4 * 16}


def fill_a_plain(t: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (torch.full((t, N_PIX, 8), 1.0, device=device),
            torch.full((t, N_PIX, 1), 2.0, device=device),
            torch.full((t, N_PIX, 1), 3, dtype=torch.int32, device=device))


def fill_b_plain(t: int, device) -> torch.Tensor:
    return torch.full((t, 16, N_PIX), 1.0, device=device)


def fill_c_plain(t: int, device) -> torch.Tensor:
    return torch.full((t, N_PIX, 8), 1.0, device=device)


def _wide(s: torch.Tensor) -> torch.Tensor:
    """Each tile's sum s[t] over the whole wide block [T, 16, 512]."""
    return s[:, None, None].expand(-1, 16, N_PIX).contiguous()


def sum_d_plain(gacc: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
                a3: torch.Tensor) -> torch.Tensor:
    dims = (1, 2)
    return _wide(gacc.sum(dims) + a1.sum(dims) + a2.sum(dims) + a3.sum(dims))


def sum_e_plain(gin: torch.Tensor) -> torch.Tensor:
    return _wide(gin.sum((1, 2)))


def probe_inputs(t: int, device) -> dict[str, tuple]:
    """The TPU probe's all-ones inputs. It passes one [T, 512, 1] array as
    a1, a2 and a3; here they are three tensors, as kernel B's acdot, gend
    and tfinal are, so that every input byte comes from memory."""
    narrow = [torch.ones((t, N_PIX, 1), device=device) for _ in range(3)]
    return {"d": (torch.ones((t, N_PIX, 8), device=device), *narrow),
            "e": (torch.ones((t, 16, N_PIX), device=device),)}


def plain_calls(t: int, device, inputs: dict[str, tuple]):
    """The plain versions of the probe's five calls, as zero-argument
    functions keyed a ... e; d and e read inputs["d"] and inputs["e"]."""
    return {"a": lambda: fill_a_plain(t, device), "b": lambda: fill_b_plain(t, device),
            "c": lambda: fill_c_plain(t, device), "d": lambda: sum_d_plain(*inputs["d"]),
            "e": lambda: sum_e_plain(*inputs["e"])}


def calls(t: int, device, inputs: dict[str, tuple]):
    """The probe's five calls, as `plain_calls` gives them: the kernels of
    csrc/probe_outspec.cu on a CUDA device, the plain versions on the CPU."""
    if torch.device(device).type == "cpu":
        return plain_calls(t, device, inputs)
    return {"a": lambda: kernels.outspec_a(t, device), "b": lambda: kernels.outspec_b(t, device),
            "c": lambda: kernels.outspec_c(t, device),
            "d": lambda: kernels.outspec_d(*inputs["d"]),
            "e": lambda: kernels.outspec_e(*inputs["e"])}


def _check(key: str, out) -> None:
    """The values every kernel of the probe must give."""
    if key == "a":
        ok = bool((out[0] == 1).all() and (out[1] == 2).all() and (out[2] == 3).all())
    else:
        ok = bool((out == ONES_SUM.get(key, 1.0)).all())
    if not ok:
        raise RuntimeError(f"{LABELS[key]}: wrong values")


def run(device, t: int = T, reps: int = 30) -> dict[str, list[float]]:
    """The five calls on `device`: one checked, then `reps` timed
    (`readings_ms`). Returns the readings per kernel, keyed a ... e."""
    dev = torch.device(device)
    readings = {}
    for key, fn in calls(t, dev, probe_inputs(t, dev)).items():
        _check(key, fn())
        readings[key] = readings_ms(fn, dev, reps)
    return readings


def main(device=None, **sizes) -> dict[str, list[float]]:
    """Run the probe on `device` (cuda unless told cpu) and print the TPU
    probe's lines, with the median time of each kernel."""
    dev = resolve_device(device)
    t = sizes.get("t", T)
    readings = run(dev, **sizes)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu, plain version"
    for key, ms in readings.items():
        med = statistics.median(ms)
        print(f"{LABELS[key]}: {med:.4f} ms ({med / t * 1e3:.4f} us/tile; median of "
              f"{len(ms)}; {where})", flush=True)
    return readings


if __name__ == "__main__":
    main(device_arg())
