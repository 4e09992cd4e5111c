"""The readings a cell's limits are set from, on the chip at the cell's
own size (the benchmark's runs do not run this):

    python3 -m gsbench.control --workload <cell> --seeds 12 --first-seed <n>

For each seed, in one process: the program's numbers (a run of the cell's
traffic, checked as a run checks it; a training run with the benchmark's
window, a render run with a short one) and the
control's: the reference computed in bfloat16, the precision below the
configuration's float32, put in the program's place. A training cell adds
its faults: the model family's (`families/<family>.py`'s `faults`), each
its reference with the fault put in the program's place (Ex4DGS: half of
each image left out of the loss, the mean over the other half; the second
moment stored without the new gradient's square); and a step that returns
its state unchanged. One JSON line per seed, then a summary:
per number, the largest program reading and the smallest reading of the
control and of each fault.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import check, drive, families, run

WINDOW_S = {"train": 0.5, "render": 2.0}


def unchanged(program: dict) -> dict:
    """A run whose steps returned their state unchanged."""
    out = {}
    for s, st in program.items():
        out[s] = dict(st, mu1=st["begin"]["mu"], after=st["begin"])
    return out


def readings(plan: dict, seed: int, device, seconds: float | None = None) -> dict:
    """{reading: {number: value}} of one seed, after a window of `seconds`
    (WINDOW_S of the cell's kind by default)."""
    cfg, mix = plan["cfg"], plan["mix"]
    seconds = WINDOW_S[mix["kind"]] if seconds is None else seconds
    rec = drive.run_cell(cfg, mix, seed, seconds, False, device)
    drive.release(device)
    out = {}
    if mix["kind"] == "train":
        fam = families.load(cfg)
        x = drive.train_inputs(cfg, mix, seed)
        prog = rec["program"]
        ref = check.reference_stretches(cfg, mix, seed, device, x, prog)

        def vs_ref(refs):
            return check.compare_train(refs, ref, fam)

        out["left_out"] = {s: sorted(set(r["grad1"]) - set(check.kept_leaves(r["grad1"])))
                           for s, r in ref.items()}
        out["program"] = check.compare_train(prog, ref, fam)
        out["control"] = vs_ref(check.reference_stretches(cfg, mix, seed, device, x, prog,
                                                          dtype=torch.bfloat16))
        for name, kw in fam.faults(cfg).items():
            out[name] = vs_ref(check.reference_stretches(cfg, mix, seed, device, x, prog, **kw))
        out["state_unchanged"] = check.compare_train(unchanged(prog), ref, fam)
    else:
        views = [v for v, _ in rec["sample"]]
        ref = check.reference_frames(cfg, seed, device, views)
        out["program"] = {"frame_rms_lsb": check.rms_lsb([b for _, b in rec["sample"]], ref)}
        ctl = check.reference_frames(cfg, seed, device, views, dtype=torch.bfloat16)
        out["control"] = {"frame_rms_lsb": check.rms_lsb(ctl, ref)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = ap.parse_args(argv)
    with open(Path.cwd() / "BENCHMARK.json") as f:
        bench = json.load(f)
    plan = run.cell_plan(bench, args.workload, False)
    # a training run's second stretch starts from the state its window
    # leaves, so the window is the benchmark's own length
    seconds = bench["run_seconds"] if plan["mix"]["kind"] == "train" else None
    if not torch.cuda.is_available():
        print("gsbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    every = []
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        r = readings(plan, seed, "cuda", seconds)
        every.append(r)
        print(json.dumps({"seed": seed, **r}), flush=True)
    summary = {}
    for kind in (k for k in every[0] if k != "left_out"):
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[kind][k] for r in every) for k in every[0][kind]}
    print(json.dumps({"summary": summary, "seeds": args.seeds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
