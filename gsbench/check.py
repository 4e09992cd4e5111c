"""The comparison that decides `correct`: what the timed path produced,
against a plain reference on the same inputs (Ex4DGS's: `reference.py`).

The reference, the optimizer's moments and the statistics' names are the
configuration's model family's (`families/<family>.py`); the comparisons
are shared.

Training: the reference follows `checked_steps` steps of the program's run
twice. The start: the run's first steps, from the seeded scene, fresh
optimizer state and statistics. The window: as many steps right after the
window closes, through the window's own call and feed, from the model,
optimizer state and statistics that the window left, which the reference
takes over (there the optimizer is some hundreds of steps in: Ex4DGS's
RAdam is on its rectified branch, where the second moment sets the update). For each
stretch, each number by its worst case:
  * loss_gap: |program's loss - reference's| / |reference's|, worst step;
  * grad_gap: the first step's gradient as the optimizer took it (worked
    out from the program's first moment before and after it), per leaf
    |‖g_p‖ - ‖g_r‖| / max(‖g_r‖, the median leaf's ‖g_r‖), worst leaf;
  * change_gap: the same of each leaf's change over the stretch;
  * moments_gap: the same of the change of each leaf's first and second
    moment;
  * stats_gap: |‖c_p‖ - ‖c_r‖| / ‖c_r‖ of the change c of each of the
    densification statistics that add up every step, worst statistic;
  * extrema_share: of each statistic that keeps an extreme (radius, least
    error and its frame), the share of rows that differ after the stretch
    beyond rounding, worst statistic. Few rows reach a new extreme in
    three steps hundreds of steps in, so a gap of norms of their change
    would turn one rounding flip into a large share.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the leaf numbers (nought to rounding: they move by
round-off).

Rendering: a seeded sample of the frames delivered in the window, each
rendered by the reference and made into bytes as the viewer makes them;
frame_rms_lsb is the worst frame's root-mean-square byte difference.
"""
from __future__ import annotations

import numpy as np
import torch

from . import families

STRETCHES = ("start", "window")
TRAIN_NUMBERS = ("loss_gap", "grad_gap", "change_gap", "moments_gap", "stats_gap",
                 "extrema_share")


def _worst(per_key: dict) -> tuple[float, str]:
    """(largest value, its key); (0, "") when there is none."""
    return max(((v, k) for k, v in per_key.items()), default=(0.0, ""))


def _leaf_gap(prog: dict, ref: dict, keep) -> tuple[float, str]:
    norms_r = {k: float(ref[k].double().norm()) for k in keep}
    floor = float(np.median(list(norms_r.values())))
    return _worst({k: abs(float(prog[k].double().norm()) - norms_r[k]) / max(norms_r[k], floor)
                   for k in keep})


def _own_gap(prog: dict, ref: dict) -> tuple[float, str]:
    """Worst |‖prog‖ - ‖ref‖| / ‖ref‖ over the keys (0 where both are 0)."""
    gaps = {}
    for k in ref:
        a, b = float(prog[k].double().norm()), float(ref[k].double().norm())
        gaps[k] = 0.0 if a == b else (abs(a - b) / b if b > 0 else float("inf"))
    return _worst(gaps)


def _extrema_share(prog: dict, ref: dict, extrema: dict) -> tuple[float, str]:
    """Of each statistic {name: (tolerance, relative)}, the share of rows
    that differ beyond the tolerance; the worst statistic."""
    shares = {}
    for k, (tol, relative) in extrema.items():
        a, b = prog[k].double(), ref[k].double()
        if b.numel():
            lim = tol * b.abs() if relative else tol
            shares[k] = float(((a - b).abs() > lim).double().mean())
    return _worst(shares)


def kept_leaves(grad: dict) -> list[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move by round-off alone."""
    norms = {k: float(v.norm()) for k, v in grad.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    return [k for k in norms if norms[k] >= floor]


def _change(run: dict, part: str) -> dict:
    return {k: run["after"][part][k].double() - run["begin"][part][k].double()
            for k in run["begin"][part]}


def first_gradient(program: dict, beta1: float) -> dict:
    """The gradient the optimizer took in a stretch's first step, from the
    first moment before and after it: (mu1 - beta1 mu0) / (1 - beta1)."""
    mu0 = program["begin"]["mu"]
    return {k: (v.double() - beta1 * mu0[k].double()) / (1.0 - beta1)
            for k, v in program["mu1"].items()}


def compare_stretch(program: dict, ref: dict, fam, where: dict | None = None) -> dict:
    """{number: value} of one stretch of the program (losses, mu1, begin,
    after; or a reference's, with grad1 for mu1) against the reference's
    (losses, grad1, begin, after), with the family `fam`'s optimizer and
    statistics. `where` gets each number's worst step, leaf or statistic."""
    keep = kept_leaves(ref["grad1"])
    grad1 = program["grad1"] if "grad1" in program else first_gradient(program, fam.BETA1)
    got = {
        "loss_gap": _worst({f"step {i}": abs(a - b) / abs(b) for i, (a, b) in
                            enumerate(zip(program["losses"], ref["losses"]))}),
        "grad_gap": _leaf_gap(grad1, ref["grad1"], keep),
        "change_gap": _leaf_gap(_change(program, "params"), _change(ref, "params"), keep),
        "moments_gap": max(_leaf_gap(_change(program, m), _change(ref, m), keep)
                           for m in ("mu", "nu")),
        "stats_gap": _own_gap(*({k: c[k] for k in fam.SUMS}
                                for c in (_change(program, "stats"), _change(ref, "stats")))),
        "extrema_share": _extrema_share(program["after"]["stats"], ref["after"]["stats"],
                                        fam.EXTREMA),
    }
    if where is not None:
        where.update({k: w for k, (_, w) in got.items()})
    return {k: v for k, (v, _) in got.items()}


def with_limits(got: dict, limits: dict) -> dict:
    return {k: (v, limits.get(k, float("nan"))) for k, v in got.items()}


def reference_stretches(cfg: dict, mix: dict, seed: int, device, x: dict, program: dict,
                        **kw) -> dict:
    """The family's reference over each stretch of the program's run (see
    its reference_stretch for kw)."""
    ref = families.load(cfg).reference_stretch
    return {s: ref(cfg, mix, seed, device, x, program[s]["begin"] if s == "window" else None,
                   program[s]["first"], **kw) for s in STRETCHES}


def compare_train(program: dict, refs: dict, fam, where: dict | None = None) -> dict:
    """{stretch.number: value} of the program's stretches against the
    reference's, with the family `fam`'s optimizer and statistics; `where`
    gets each number's worst step, leaf or statistic."""
    out = {}
    for s in STRETCHES:
        w = {}
        out.update({f"{s}.{k}": v
                    for k, v in compare_stretch(program[s], refs[s], fam, w).items()})
        if where is not None:
            where.update({f"{s}.{k}": v for k, v in w.items()})
    return out


def train(cfg: dict, mix: dict, seed: int, device, x: dict, program: dict,
          limits: dict) -> dict:
    """The training numbers of the program's run (see the module
    docstring) against the float64 reference, each with its limit."""
    refs = reference_stretches(cfg, mix, seed, device, x, program)
    where = {}
    got = compare_train(program, refs, families.load(cfg), where)
    print("# worst: " + ", ".join(f"{k} {w}" for k, w in where.items()), flush=True)
    return with_limits(got, limits)


def to_bytes(img: torch.Tensor) -> np.ndarray:
    """The viewer's conversion of a frame in [0, 1] to bytes (clip, x255,
    truncate), from any dtype."""
    return (np.clip(img.double().cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def reference_frames(cfg: dict, seed: int, device, views, dtype=torch.float64) -> list:
    """The family's reference's bytes of each (camera, t) in `views`."""
    frames = families.load(cfg).reference_frames(cfg, seed, device, views, dtype)
    return [to_bytes(f) for f in frames]


def render(cfg: dict, seed: int, device, sample, limits: dict) -> dict:
    """frame_rms_lsb of the sampled frames ((camera, t), bytes) against the
    float64 reference."""
    ref = reference_frames(cfg, seed, device, [v for v, _ in sample])
    return with_limits({"frame_rms_lsb": rms_lsb([b for _, b in sample], ref)}, limits)


def rms_lsb(got: list, ref: list) -> float:
    """The worst frame's root-mean-square difference in byte steps."""
    worst = 0.0
    for a, b in zip(got, ref):
        d = a.astype(np.float64) - b.astype(np.float64)
        worst = max(worst, float(np.sqrt(np.mean(d * d))))
    return worst


def passed(numbers: dict) -> bool:
    """Every number within its limit (a NaN is not)."""
    return all(v <= lim for v, lim in numbers.values())
