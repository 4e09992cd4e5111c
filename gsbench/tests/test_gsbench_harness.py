"""The harness finds every cell's configuration, traffic, limits and
metric readers by name, and BENCHMARK.json is well formed."""
import json
import re
import shutil
import subprocess
import sys

from conftest import ROOT

from gsbench import check, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files_by_name(bench):
    for w in bench["workloads"]:
        for traced in (False, True):
            plan = run.cell_plan(bench, w["name"], traced)
            assert plan["cfg"]["name"] == w["config"]
            assert plan["mix"]["kind"] in ("train", "render")
            assert plan["metrics"], (w["name"], traced)
            for m in plan["metrics"]:
                assert callable(run.load_reader(m["name"]).read)
            numbers = {"train": {f"{s}.{n}" for s in check.STRETCHES
                                 for n in check.TRAIN_NUMBERS},
                       "render": {"frame_rms_lsb"}}[plan["mix"]["kind"]]
            assert set(plan["limits"]) == numbers


def test_benchmark_json_is_well_formed(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gsbench"] and 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += list(e2e) + [m["name"] for m in bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gsbench/") and (ROOT / c["file"]).is_file()
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "gsbench.run", "--workload", "n3v.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """Beside BENCHMARK.json and gsbench/ only, the program is missing: the
    run fails before it could print a result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gsbench", tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import json; from gsbench import run; "
            "plan = run.cell_plan(json.load(open('BENCHMARK.json')), 'n3v.train', False); "
            "run.measure(plan, 1, 0.1, False, 'cpu', 0.0); print('{}')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "ex4dgs_tpu_torch" in proc.stderr
    assert "{}" not in proc.stdout
