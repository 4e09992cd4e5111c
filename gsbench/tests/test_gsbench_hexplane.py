"""The 4D-GS family (`families/hexplane.py`) through the harness on the CPU
at a tiny size: it gives every name the harness calls, its census counts
the deformed Gaussian-views, a sound training run is correct, and each of
the control's faults moves the reference."""
import pytest
import torch
from conftest import ROOT, TINY_MIX

from gsbench import check, drive, families, run
from gsbench import reference_hexplane as HR
from gsbench.families import hexplane

TINY = {"width": 200, "height": 120, "n_gaussians": 3000}
SEED = 2**31 + 4343


@pytest.fixture
def plan_hexplane(bench, monkeypatch):
    monkeypatch.chdir(ROOT)
    p = run.cell_plan(bench, "n3v_hexplane.train", False)
    p["cfg"].update(TINY)
    p["mix"].update(TINY_MIX, warmup_steps=4)
    return p


def test_the_family_gives_every_name_the_harness_calls(plan_hexplane):
    fam = families.load(plan_hexplane["cfg"])
    assert fam is hexplane
    for name in ("VIEWS_PER_STEP", "make_params", "Program", "census", "reference_stretch",
                 "reference_frames", "SUMS", "EXTREMA", "BETA1", "faults"):
        assert hasattr(fam, name), name
    assert fam.VIEWS_PER_STEP == 4 and fam.BETA1 == HR.BETA1


def test_the_census_counts_the_deformed_gaussian_views(plan_hexplane):
    cfg = plan_hexplane["cfg"]
    sc = hexplane.make_params(cfg, SEED, "cpu")
    prog = hexplane.Program(cfg, "cpu")
    x = drive.train_inputs(cfg, plan_hexplane["mix"], SEED)
    views = [(x["cams"][i], 10.0 * i) for i in range(4)]
    w = hexplane.census(cfg, sc, prog.model(sc), views)
    assert w["deformed"] == 4 * 3000 and w["views"] == 4 and "gaussians" not in w
    assert w["plane_elements"] == 9_461_760 // 4
    assert 0 < w["visible"] <= w["deformed"] and w["pixels"] == 4 * 200 * 120


def test_a_sound_training_run_is_correct(plan_hexplane):
    out = run.measure(plan_hexplane, SEED, 0.2, False, "cpu", 0.0)
    assert out["correct"], out["numbers"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_each_fault_moves_the_reference(plan_hexplane):
    """Each fault's first step differs from the sound reference's: in its
    loss, or in some parameter's gradient; the bfloat16 control's first step
    fails at least one of the cell's limits."""
    cfg, mix = plan_hexplane["cfg"], dict(plan_hexplane["mix"], checked_steps=1)
    x = drive.train_inputs(cfg, mix, SEED)
    sound = hexplane.reference_stretch(cfg, mix, SEED, "cpu", x)
    for name, kw in hexplane.faults(cfg).items():
        got = hexplane.reference_stretch(cfg, mix, SEED, "cpu", x, **kw)
        moved = max(float((got["grad1"][k] - g).abs().max()) / float(g.abs().max())
                    for k, g in sound["grad1"].items() if g.abs().max() > 0)
        assert got["losses"][0] != sound["losses"][0] or moved > 1e-6, name
    # the control, the reference in bfloat16, fails the cell's limits
    low = hexplane.reference_stretch(cfg, mix, SEED, "cpu", x, dtype=torch.bfloat16)
    got = check.compare_stretch(low, sound, hexplane)
    assert any(v > plan_hexplane["limits"][f"start.{k}"] for k, v in got.items()), got
