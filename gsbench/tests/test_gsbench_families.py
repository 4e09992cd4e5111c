"""Model families (`gsbench/families/`): the lookup by name, the check's
numbers held to those recorded before the families existed, and a second
family added from new files alone."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import ROOT

from gsbench import drive, families, run

SEED = 2**31 + 101
# The check's numbers of each cell at the tiny size, seed SEED and a window
# cut to CALLS calls, as the harness gave them before its Ex4DGS parts moved
# into families/ex4dgs.py. The window's length sets which steps the second
# training stretch follows and which frames the render check samples, so a
# fixed count makes two runs comparable.
CALLS = {"n3v.train": 3, "technicolor.render": 5}
PARENT = {
    "n3v.train": {
        "start.loss_gap": 8.386555763033696e-08, "start.grad_gap": 7.397123365070761e-07,
        "start.change_gap": 3.2665060953399454e-06,
        "start.moments_gap": 3.2293408728023924e-06,
        "start.stats_gap": 4.906411638916262e-06, "start.extrema_share": 0.0,
        "window.loss_gap": 1.6506497377969254e-07, "window.grad_gap": 1.2202008317746581e-06,
        "window.change_gap": 0.000571886115357897,
        "window.moments_gap": 1.4566657829379777e-05,
        "window.stats_gap": 4.6520311153715205e-06, "window.extrema_share": 0.0},
    "technicolor.render": {"frame_rms_lsb": 0.009128709291752768},
}


def fixed_window(n: int):
    """drive._window that makes exactly n calls."""
    def window(call, seconds, first, device):
        for i in range(first, first + n):
            call(i)
        drive.sync(device)
        return n, 1.0
    return window


@pytest.mark.parametrize("cell", sorted(PARENT))
def test_the_check_numbers_are_the_parents(tiny_plan, monkeypatch, cell):
    monkeypatch.setattr(drive, "_window", fixed_window(CALLS[cell]))
    out = run.measure(tiny_plan(cell), SEED, 0.2, False, "cpu", 0.0)
    assert {k: v for k, (v, _) in out["numbers"].items()} == PARENT[cell]


def test_load_defaults_to_ex4dgs_and_names_the_families():
    assert families.load({}) is families.load({"family": "ex4dgs"})
    assert families.load({}).__name__ == "gsbench.families.ex4dgs"
    for name in ("nope", "../drive", "ex4dgs.py"):
        with pytest.raises(SystemExit, match=r"unknown family .*; gsbench/families has \["):
            families.load({"family": name})
    with pytest.raises(SystemExit) as exc:
        families.load({"family": "nope"})
    assert "'ex4dgs'" in str(exc.value)


# A second family, written as a later change would add one: Ex4DGS with two
# views a training step, of which it trains on the first; it records the
# pool entries each step got (a pool image is a view at its entry's offset).
STUB = '''"""A stub family: Ex4DGS taking two views a training step."""
from gsbench.families import ex4dgs
from gsbench.families.ex4dgs import *  # noqa: F401,F403

VIEWS_PER_STEP = 2
STEPS = []


class _FirstOfEach:
    def __init__(self, schedule, n):
        self.schedule, self.n = schedule, n

    def __getitem__(self, i):
        return self.schedule[self.n * i]


class Program(ex4dgs.Program):
    def step(self, carried, cams, gts, ts, bg, iteration):
        STEPS.append((iteration, [g.storage_offset() // g.numel() for g in gts], list(ts)))
        return super().step(carried, cams[:1], gts[:1], ts[:1], bg, iteration)


def reference_stretch(cfg, mix, seed, device, x, *args, **kw):
    x = dict(x, views=1, schedule=_FirstOfEach(x["schedule"], VIEWS_PER_STEP))
    return ex4dgs.reference_stretch(cfg, mix, seed, device, x, *args, **kw)
'''

DRIVE_STUB = '''
import json, sys
sys.path.insert(0, "gsbench/tests")
from conftest import TINY_CFG, TINY_MIX
import gsbench
from gsbench import drive, run
from gsbench.families import stub
assert gsbench.__file__.startswith(sys.argv[1]), gsbench.__file__
bench = json.load(open("BENCHMARK.json"))
res = {}
for cell in ("stub.train", "stub.render"):
    plan = run.cell_plan(bench, cell, False)
    plan["cfg"].update(TINY_CFG)
    plan["mix"].update(TINY_MIX)
    out = run.measure(plan, %d, 0.2, False, "cpu", 0.0)
    res[cell] = {k: out[k] for k in ("correct", "attempted", "failed", "numbers")}
    if cell == "stub.train":
        x = drive.train_inputs(plan["cfg"], plan["mix"], %d)
        res["first_iteration"] = plan["mix"]["first_iteration"]
res["schedule"] = [x["schedule"][i] for i in range(2 * len(stub.STEPS))]
res["pool_t"] = x["pool_t"]
res["steps"] = stub.STEPS
print(json.dumps(res))
''' % (SEED, SEED)


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_second_family_needs_only_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gsbench", tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    g = tmp_path / "gsbench"
    (g / "families" / "stub.py").write_text(STUB)
    cfg = json.loads((ROOT / "gsbench/configs/n3v.json").read_text())
    (g / "configs" / "stub.json").write_text(json.dumps(cfg | {"name": "stub", "family": "stub"}))
    for cell, like in (("stub.train", "n3v.train"), ("stub.render", "technicolor.render")):
        shutil.copy(g / "checks" / f"{like}.json", g / "checks" / f"{cell}.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub", "source": "https://example.org/stub",
                             "file": "gsbench/configs/stub.json", "reduced": [],
                             "why": "a test family"})
    for cell, traffic, like in (("stub.train", "train_closed", "n3v.train"),
                                ("stub.render", "render_closed", "technicolor.render")):
        bench["workloads"].append({"name": cell, "config": "stub", "traffic": traffic,
                                   "chips": 1, "why": "a test cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", DRIVE_STUB, str(tmp_path)], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for cell in ("stub.train", "stub.render"):
        assert res[cell]["correct"], (cell, res[cell]["numbers"])
        assert res[cell]["attempted"] > 0 and res[cell]["failed"] == 0
    # every step got the schedule's next pair of entries, in order
    first = res["first_iteration"]
    steps = res["steps"]
    assert [it for it, _, _ in steps] == list(range(first, first + len(steps)))
    sched = res["schedule"]
    for it, got, ts in steps:
        i = it - first
        assert got == sched[2 * i:2 * i + 2], (i, got)
        assert ts == [res["pool_t"][e] for e in got]
    # adding the family touched no file that was there
    before = _digests(ROOT / "gsbench")
    after = _digests(g)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {"families/stub.py", "configs/stub.json",
                                        "checks/stub.train.json", "checks/stub.render.json"}
