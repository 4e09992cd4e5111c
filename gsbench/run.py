"""Run one cell of BENCHMARK.json and print its result line.

    python3 -m gsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration
(`configs/<name>.json`) and a traffic mix (`traffic/<name>.json`); each
metric is read by `metrics/<name>.py`; the check's limits are in
`checks/<cell>.json`. With `--trace 0` the line carries the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, the device's
busy and traced seconds and a breakdown. The last line of standard output
is the result; the last lines of standard error are the numbers the check
compared, each beside its limit.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python gets

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ex4dgs_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ex4dgs_tpu_torch is not ex4dgs_tpu)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_reader(name: str):
    """The reader of metric `name`: metrics/<name>.py, or for a quantity
    split by the end-to-end metric it moves (`<quantity>.<part>`, as
    `dispatch_ms.train`), metrics/<quantity>.py."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"gsbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_plan(bench: dict, workload: str, traced: bool) -> dict:
    """The cell's entry, configuration, traffic mix, limits and the metrics
    its line carries, all found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(Path.cwd() / config["file"]) as f:
        cfg = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    with open(HERE / "checks" / f"{workload}.json") as f:
        limits = json.load(f)
    group = bench["per_layer" if traced else "end_to_end"]
    metrics = [m for m in group if workload in m.get("workloads", [workload])]
    return {"cell": cell, "cfg": cfg, "mix": mix, "limits": limits, "metrics": metrics}


def card() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def measure(plan: dict, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """Run the cell on `device` and read its metrics and its check: the
    result line's fields, less `device`."""
    from . import check, drive

    rec = drive.run_cell(plan["cfg"], plan["mix"], seed, seconds, traced, device)
    rec["setup_s"] = rec["setup_end"] - t0
    if traced:
        cache = {}
        work = rec["work"]
        rec["work"] = lambda: cache.setdefault("w", work())
    metrics = {}
    for m in plan["metrics"]:
        v = load_reader(m["name"]).read(rec)
        if v is not None:  # a reader that finds nothing to read is left out
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    drive.release(device)
    t_check = time.perf_counter()
    numbers = rec["check"](plan["limits"])
    lat = rec.get("latencies_s") or [0.0]
    print(f"# setup {rec['setup_s']:.3f} s, window {rec['window_s']:.3f} s for {rec['calls']} "
          f"calls, check {time.perf_counter() - t_check:.3f} s; dispatch median "
          f"{1e3 * statistics.median(rec['dispatch_s'] or [0.0]):.3f} ms, latency median "
          f"{1e3 * statistics.median(lat):.3f} ms, max {1e3 * max(lat):.3f} ms", flush=True)
    out = {"correct": check.passed(numbers), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "memory_peak_bytes": rec["memory_peak_bytes"], "numbers": numbers}
    if traced:
        from . import trace

        prof = rec["profile"]
        out["busy_s"], out["window_s"] = prof["busy_s"], prof["wall_s"]
        out["breakdown"] = trace.breakdown(prof)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(Path.cwd() / "BENCHMARK.json") as f:
        bench = json.load(f)
    plan = cell_plan(bench, args.workload, bool(args.trace))

    import torch

    chips = plan["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gsbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    power = card()
    print(f"# card: {power}", flush=True)
    out = measure(plan, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"gsbench: the run loaded {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"]),
              "power_limit": power}
    if args.trace:
        device["busy_s"], device["window_s"] = out["busy_s"], out["window_s"]
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if args.trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["numbers"].items()}
    print(json.dumps(line), flush=True)
    for k, (v, lim) in out["numbers"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
