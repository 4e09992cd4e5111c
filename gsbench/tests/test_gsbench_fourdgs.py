"""The 4D Gaussian Splatting family (`families/fourdgs.py`) through the
harness on the CPU at a tiny size: a sound training run and a render run
are correct; the control's faults and the bfloat16 control each fail a
check number of `n3v_4dgs.train`'s limits."""
import json

import pytest
from conftest import ROOT, TINY_MIX

from gsbench import check, control, run

TINY_4DGS = {"width": 200, "height": 120, "n_gaussians": 3000}
SEED = 2**31 + 4242


@pytest.fixture
def plan_4dgs(bench, monkeypatch):
    """plan(traced=False): n3v_4dgs.train's plan at the tiny size."""
    monkeypatch.chdir(ROOT)

    def plan(traced: bool = False) -> dict:
        p = run.cell_plan(bench, "n3v_4dgs.train", traced)
        p["cfg"].update(TINY_4DGS)
        p["mix"].update(TINY_MIX)
        return p

    return plan


def test_a_sound_training_run_is_correct(plan_4dgs):
    out = run.measure(plan_4dgs(True), SEED, 0.2, True, "cpu", 0.0)
    assert out["correct"], out["numbers"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["numbers"]) == {f"{s}.{n}" for s in check.STRETCHES
                                   for n in check.TRAIN_NUMBERS}
    # the whole step's share reads the family's census; the kernels' shares
    # find no kernel on the CPU
    assert 0 < out["metrics"]["mfu_4dgs.train_step"]["value"] < 100
    assert "slice4d_fwd_roofline" not in out["metrics"]


def test_a_render_run_is_correct(plan_4dgs, bench):
    p = plan_4dgs()
    with open(ROOT / "gsbench" / "traffic" / "render_closed.json") as f:
        mix = json.load(f) | TINY_MIX
    with open(ROOT / "gsbench" / "checks" / "n3v.render.json") as f:
        limits = json.load(f)
    plan = {"cell": p["cell"], "cfg": p["cfg"], "mix": mix, "limits": limits, "metrics": []}
    out = run.measure(plan, SEED, 0.2, False, "cpu", 0.0)
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["numbers"]["frame_rms_lsb"][0] < 0.1


def test_every_fault_and_the_control_fail(plan_4dgs, monkeypatch):
    """The program within every limit; each fault (the opacity unscaled by
    the marginal, the mean without its offset, time degree 0, a view left
    out of the loss, Adam's second moment unfed), the bfloat16 reference
    and a step that returns its state unchanged each beyond some limit."""
    monkeypatch.setattr(control, "WINDOW_S", {"train": 0.1, "render": 0.2})
    plan = plan_4dgs()
    r = control.readings(plan, 9, "cpu")
    assert set(r) == {"left_out", "program", "control", "marginal_off", "mean_offset_off",
                      "time_sh_off", "three_of_four_views", "adam_nu_unfed", "state_unchanged"}
    assert check.passed({k: (v, plan["limits"][k]) for k, v in r["program"].items()})
    for name in set(r) - {"left_out", "program"}:
        assert not check.passed({k: (v, plan["limits"][k]) for k, v in r[name].items()}), name
