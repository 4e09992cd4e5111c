"""Fixtures of the benchmark's CPU tests: a cell's plan cut to a size the
CPU runs in seconds (the limits stay the cell's). The training warm-up is
long enough that the second checked stretch runs where RAdam's rectified
update has settled, as it has after a window on the card."""
import json
import os
from pathlib import Path

import pytest
import torch

# Two threads a process: the suite runs in several pytest workers at once,
# and each would otherwise take every core.
torch.set_num_threads(min(2, os.cpu_count() or 1))

ROOT = Path(__file__).resolve().parents[2]

TINY_CFG = {"width": 200, "height": 120, "n_static": 3000, "n_dynamic": 300}
TINY_MIX = {"gt_frames": 8, "warmup_steps": 20, "profiled_calls": 2, "path_frames": 12,
            "warmup_calls": 2, "checked_frames": 2}


@pytest.fixture
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture
def tiny_plan(bench, monkeypatch):
    """plan(cell, traced=False): the cell's plan at the tiny size."""
    from gsbench import run

    monkeypatch.chdir(ROOT)

    def plan(cell: str, traced: bool = False) -> dict:
        p = run.cell_plan(bench, cell, traced)
        p["cfg"].update(TINY_CFG)
        p["mix"].update(TINY_MIX)
        return p

    return plan
