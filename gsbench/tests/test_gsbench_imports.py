"""A run loads no JAX and no JAX package; the reference loads nothing of
the program."""
import subprocess
import sys

from conftest import ROOT

from gsbench import run


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ex4dgs_tpu_torch_fake", object())
    assert "ex4dgs_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ex4dgs_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert {"ex4dgs_tpu.fake", "jaxlib.fake"} <= set(run.forbidden_modules())


def _fresh(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    code = ("import json, sys; sys.path.insert(0, 'gsbench/tests'); from conftest import *; "
            "from gsbench import run; "
            "plan = run.cell_plan(json.load(open('BENCHMARK.json')), 'technicolor.render', True); "
            "plan['cfg'].update(TINY_CFG); plan['mix'].update(TINY_MIX); "
            "out = run.measure(plan, 3, 0.2, True, 'cpu', 0.0); "
            "assert 'frame_rms_lsb' in out['numbers']; "
            "print(run.forbidden_modules(), 'ex4dgs_tpu_torch' in sys.modules)")
    assert _fresh(code) == "[] True"


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import torch; from gsbench import check, counts, reference, scene; "
            "sc = scene.make_params({**__import__('json').load(open('gsbench/configs/n3v.json')), "
            "'n_static': 500, 'n_dynamic': 50, 'width': 96, 'height': 64}, 1, 'cpu'); "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('ex4dgs')))")
    assert _fresh(code) == "[]"
