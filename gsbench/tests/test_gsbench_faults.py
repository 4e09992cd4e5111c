"""The check fails runs whose timed path is broken underneath, and its
control: each run here skips the look for a card and drives the rest of
a run on the CPU at a tiny size, against the cell's own limits."""
import dataclasses

import pytest
import torch

from gsbench import check, control, run


def _run(plan, seed=2**31 + 77):
    return run.measure(plan, seed, 0.2, False, "cpu", 0.0)


def test_sound_runs_are_correct(tiny_plan):
    for cell in ("n3v.train", "technicolor.render"):
        out = _run(tiny_plan(cell))
        assert out["correct"], (cell, out["numbers"])
        assert out["attempted"] > 0 and out["failed"] == 0


def test_a_step_that_returns_its_state_unchanged_fails(tiny_plan, monkeypatch):
    from ex4dgs_tpu_torch.train import step as step_mod

    real = step_mod.train_step

    def unchanged(model, opt_state, *args, **kwargs):
        return real(model, opt_state, *args, **kwargs)._replace(model=model,
                                                                opt_state=opt_state)

    monkeypatch.setattr(step_mod, "train_step", unchanged)
    out = _run(tiny_plan("n3v.train"))
    assert not out["correct"]
    for stretch in check.STRETCHES:
        assert out["numbers"][f"{stretch}.change_gap"][0] == pytest.approx(1.0)


def test_a_second_moment_stored_without_the_new_square_fails(tiny_plan, monkeypatch):
    """RAdam's update as it should be, but nu stored as beta2 nu alone."""
    from ex4dgs_tpu_torch.models.optimizer import BETA2
    from ex4dgs_tpu_torch.train import step as step_mod

    real = step_mod.radam_update

    def unfed(params, grads, state, lrs):
        new_params, new_state = real(params, grads, state, lrs)
        return new_params, dataclasses.replace(
            new_state, nu={k: BETA2 * v for k, v in state.nu.items()})

    monkeypatch.setattr(step_mod, "radam_update", unfed)
    out = _run(tiny_plan("n3v.train"))
    assert not out["correct"]
    for stretch in check.STRETCHES:
        value, limit = out["numbers"][f"{stretch}.moments_gap"]
        assert value > limit, (stretch, value, limit)


def test_statistics_left_unchanged_fail(tiny_plan, monkeypatch):
    """The densification statistics never accumulate."""
    from ex4dgs_tpu_torch.train import step as step_mod

    monkeypatch.setattr(step_mod, "_update_stat_accumulators", lambda model, *a, **k: model)
    out = _run(tiny_plan("n3v.train"))
    assert not out["correct"]
    for stretch in check.STRETCHES:
        assert out["numbers"][f"{stretch}.stats_gap"][0] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_fails(tiny_plan, monkeypatch):
    """The loss over the top half of each image, the mean over the rest."""
    from ex4dgs_tpu_torch.train import step as step_mod

    real = step_mod._image_loss

    def half(res, gt, opt):
        h = gt.shape[0] // 2
        return real(res._replace(render=res.render[:h], acc=res.acc[:h],
                                 opticalflow=res.opticalflow[:h]), gt[:h], opt)

    monkeypatch.setattr(step_mod, "_image_loss", half)
    out = _run(tiny_plan("n3v.train"))
    assert not out["correct"], out["numbers"]


def test_an_answer_altered_where_it_is_made_fails(tiny_plan, monkeypatch):
    """One band of 16 rows of every frame zeroed where the render makes it."""
    from ex4dgs_tpu_torch import rendering

    real = rendering.render

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        img = res.render.clone()
        img[16:32] = 0.0
        return res._replace(render=img)

    monkeypatch.setattr(rendering, "render", altered)
    out = _run(tiny_plan("technicolor.render"))
    assert not out["correct"], out["numbers"]


@pytest.mark.parametrize("cell", ["n3v.train", "technicolor.render"])
def test_the_control_fails(tiny_plan, monkeypatch, cell):
    """The reference in bfloat16 in the program's place is not correct."""
    monkeypatch.setattr(control, "WINDOW_S", {"train": 0.1, "render": 0.2})
    plan = tiny_plan(cell)
    r = control.readings(plan, 9, "cpu")
    assert check.passed({k: (v, plan["limits"][k]) for k, v in r["program"].items()})
    assert not check.passed({k: (v, plan["limits"][k]) for k, v in r["control"].items()})


@pytest.mark.cuda
def test_the_control_fails_on_the_card(tiny_plan, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(control, "WINDOW_S", {"train": 0.2, "render": 0.5})
    for cell in ("n3v.train", "technicolor.render"):
        plan = tiny_plan(cell)
        r = control.readings(plan, 9, "cuda")
        assert check.passed({k: (v, plan["limits"][k]) for k, v in r["program"].items()})
        assert not check.passed({k: (v, plan["limits"][k]) for k, v in r["control"].items()})
