"""Evaluation/render CLI of the port — the reference's render.py:126-161
surface, the JAX package's `render_cli.py` run on one CUDA device.

    python -m ex4dgs_tpu_torch.render_cli --model_path <trained model dir> \
        [--iteration N] [--skip_train] [--skip_test] [--save_images] \
        [--fps_inner N] [--device cpu]

Reads the model directory's `cfg_args.json`, builds the Scene from its
source path, loads `chkpntN.npz` (or else the iteration's PLY pair; the
newest iteration by default) onto the device, renders the test and train
splits and writes `<split>/ours_N/{mean_metrics,all_metrics,
all_metrics_rows}.json` (`eval/render_sets.py`). A model directory written
by either package's trainer evaluates here. The run is on `cuda` unless
--device names another device, and raises where there is no CUDA device.
It renders with the tile shape, depth sort and tight cull that the JAX
CLI's EX4DGS_TILE, EX4DGS_EXACT_SORT and EX4DGS_TIGHT_CULL ask for
(`KernelConfig.from_env`, read by `render_set`), as the JAX CLI does.
Besides the JAX CLI's output it prints, per split, one line
`eval_report {json}`: the kernel config `render_set` rendered with, its
stage timings and the kernels' launch counts.
"""
from __future__ import annotations

import argparse
import json
import os


def newest_iteration(model_path: str) -> int:
    """The largest N of point_cloud/iteration_N and chkpntN.npz."""
    pc_dir = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[-1]) for d in os.listdir(pc_dir)] if os.path.isdir(pc_dir) else []
    ckpts = [int(f[6:-4]) for f in os.listdir(model_path)
             if f.startswith("chkpnt") and f.endswith(".npz")]
    return max(iters + ckpts)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m ex4dgs_tpu_torch.render_cli")
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--save_images", action="store_true")
    parser.add_argument("--fps_inner", type=int, default=500,
                        help="re-renders per timing round (reference: 500)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to evaluate on (default cuda)")
    args = parser.parse_args(argv)

    from . import kernels, resolve_device
    from .data.scene import Scene
    from .eval.render_sets import render_set
    from .models.config import ModelConfig, overlay_json
    from .models.density import push

    dev = resolve_device(args.device)  # raises before anything is read without CUDA
    cfg = overlay_json(ModelConfig(), os.path.join(args.model_path, "cfg_args.json"))
    scene = Scene(cfg, model_path=args.model_path)
    it = newest_iteration(args.model_path) if args.iteration == -1 else args.iteration

    ckpt = os.path.join(args.model_path, f"chkpnt{it}.npz")
    if os.path.exists(ckpt):
        from .io.checkpoint import load_checkpoint

        hm, _, _ = load_checkpoint(ckpt)
    else:
        from .io.model_ply import load_model_ply

        hm = load_model_ply(os.path.join(args.model_path, "point_cloud", f"iteration_{it}",
                                         "point_cloud.ply"), cfg, duration=scene.duration)
    model, _ = push(hm, cfg, device=dev)
    scene.set_sampling_len(hm.duration)

    results = {}
    for split, skip in (("test", args.skip_test), ("train", args.skip_train)):
        if skip:
            continue
        out_dir = os.path.join(args.model_path, split, f"ours_{it}")
        timings = {}
        kernels.reset_launches()
        results[split] = render_set(model, cfg, scene, split, out_dir,
                                    save_images=args.save_images,
                                    measure_fps=(split == "test"), fps_inner=args.fps_inner,
                                    timings=timings, device=dev)
        print(split, json.dumps(results[split], indent=1), flush=True)
        print("eval_report " + json.dumps({"split": split, "device": str(dev),
                                           "kernel_config": timings.pop("kernel_config"),
                                           "timings": timings,
                                           "kernel_launches": dict(kernels.launches)}),
              flush=True)
    return results


if __name__ == "__main__":
    main()
