"""Model families: everything of the benchmark that belongs to one 4D
Gaussian representation, one module each (`families/<name>.py`), found by
the configuration's `family` key as metrics are found by name.

A family module gives what the shared generator (`drive.py`), the check
(`check.py`) and the control (`control.py`) call through:
  * `VIEWS_PER_STEP`: the views one training step takes (step i takes the
    schedule's entries V i .. V i + V - 1);
  * the scene: `make_params(cfg, seed, device, perturb=None)`;
  * `Program(cfg, device)`: the system under test, with `capacity`,
    `model(scene)`, `camera(host_camera)`, `render(model, camera, t)`, and
    for training `start(model) -> carried`, `step(carried, cams, gts, ts,
    bg, iteration) -> (loss, binning_total, nan_flag)`, `snapshot(carried)`
    and `current(carried) -> model`;
  * the yardstick's `census(cfg, scene, model, views)`;
  * the reference: `reference_stretch(...)` and `reference_frames(...)`,
    with the names of the statistics the check treats as sums (`SUMS`) and
    as extrema (`EXTREMA`), and the optimizer's `BETA1`;
  * the control's faults: `faults(cfg) -> {name: reference_stretch kw}`.
"""
from __future__ import annotations

import importlib
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT = "ex4dgs"


def present() -> list[str]:
    """The families of this checkout."""
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def load(cfg: dict):
    """The module of the configuration's family (`family`, by default
    ex4dgs)."""
    name = cfg.get("family", DEFAULT)
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", str(name)) or name not in present():
        raise SystemExit(f"unknown family {name!r}; gsbench/families has {present()}")
    return importlib.import_module(f"{__name__}.{name}")
