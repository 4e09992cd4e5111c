"""The `<layer>_host_ms` readers (`gsbench/spans.py`): a tiny traced CPU run
of each cell gives a positive number for every layer metric of the cell;
the layers a render does not run, an untraced run and a program that
records no spans give none."""
import pytest

from gsbench import drive, run

LAYERS = {"train": ("temporal", "preprocess", "binning", "composite", "loss", "backward",
                    "update"),
          "render": ("temporal", "preprocess", "binning", "composite")}


@pytest.mark.parametrize("cell", ["n3v.train", "technicolor.render"])
def test_a_traced_run_reads_every_layer_of_its_cell(tiny_plan, monkeypatch, cell):
    from ex4dgs_tpu_torch.runtime import profiling

    profiling.span_reset()
    plan = tiny_plan(cell, traced=True)
    kind = plan["mix"]["kind"]
    rec = drive.run_cell(plan["cfg"], plan["mix"], 2**31 + 41, 0.2, True, "cpu")
    assert profiling.span_summary()["calls"] == plan["mix"]["profiled_calls"]
    names = {m["name"] for m in plan["metrics"] if m["name"].endswith(f"_host_ms.{kind}")}
    assert names == {f"{layer}_host_ms.{kind}" for layer in LAYERS[kind]}
    for name in names:
        assert run.load_reader(name).read(rec) > 0, name
    others = set(LAYERS["train"]) - set(LAYERS[kind])
    assert [run.load_reader(f"{layer}_host_ms").read(rec) for layer in others] == \
        [None] * len(others)
    # the record still holds the traced calls, but an untraced run reads none
    for layer in LAYERS["train"]:
        assert run.load_reader(f"{layer}_host_ms").read(dict(rec, profile=None)) is None
    # nor does a program that records no spans
    monkeypatch.delattr(profiling, "span_summary")
    assert run.load_reader("temporal_host_ms").read(rec) is None


def test_an_untraced_run_reads_none(tiny_plan):
    from ex4dgs_tpu_torch.runtime import profiling

    profiling.span_reset()
    plan = tiny_plan("technicolor.render")
    rec = drive.run_cell(plan["cfg"], plan["mix"], 2**31 + 43, 0.2, False, "cpu")
    assert profiling.span_summary()["calls"] == 0
    for layer in LAYERS["train"]:
        assert run.load_reader(f"{layer}_host_ms").read(rec) is None
