"""The `<layer>_host_ms` readers (`gsbench/spans.py`): a tiny traced CPU run
of `technicolor.render` gives a positive number for every layer metric of
the cell; an untraced run and a program that records no spans give none.
The training cell lists none of them: its step is replayed as a CUDA graph
on the card, and a replay opens no layer span. `n3v.render` lists none
either: there the frame time is itself a per-layer metric
(`viewer_frame_ms`), and the layers' metrics move `frame_ms`, which that
cell does not report."""
import pytest

from gsbench import drive, run

LAYERS = ("temporal", "preprocess", "binning", "composite")


@pytest.mark.parametrize("cell", ["technicolor.render", "n3v.render"])
def test_a_traced_run_reads_every_layer_of_its_cell(tiny_plan, monkeypatch, cell):
    from ex4dgs_tpu_torch.runtime import profiling

    profiling.span_reset()
    plan = tiny_plan(cell, traced=True)
    rec = drive.run_cell(plan["cfg"], plan["mix"], 2**31 + 41, 0.2, True, "cpu")
    assert profiling.span_summary()["calls"] == plan["mix"]["profiled_calls"]
    names = {m["name"] for m in plan["metrics"] if "_host_ms." in m["name"]}
    if cell == "n3v.render":
        assert not names
        assert [m["name"] for m in plan["metrics"]] == ["viewer_frame_ms"]
        assert run.load_reader("viewer_frame_ms").read(rec) == \
            run.load_reader("frame_ms").read(rec) > 0
        names = {f"{layer}_host_ms.render" for layer in LAYERS}
    assert names == {f"{layer}_host_ms.render" for layer in LAYERS}
    for name in names:
        assert run.load_reader(name).read(rec) > 0, name
    # the record still holds the traced calls, but an untraced run reads none
    for layer in LAYERS:
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
    for layer in LAYERS:
        assert run.load_reader(f"{layer}_host_ms").read(rec) is None


def test_the_training_cell_lists_no_layer_span_metric(tiny_plan):
    plan = tiny_plan("n3v.train", traced=True)
    assert not [m["name"] for m in plan["metrics"] if "_host_ms" in m["name"]]
