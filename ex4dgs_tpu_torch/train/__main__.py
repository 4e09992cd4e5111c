"""Training CLI of the port — the JAX package's `train.py` surface, run on
one CUDA device.

    python -m ex4dgs_tpu_torch.train --config configs/N3V/n3v_base.json \
        --source_path <scene> --model_path <out> [--iterations N] \
        [--start_checkpoint chkpntN.npz] [--device cpu]

A JSON config overlays the ModelConfig/OptimizationConfig defaults first
(unknown keys ignored), then every field of either is settable as
--<name>. The run trains on `cuda` unless --device names another device,
and raises where there is no CUDA device instead of training on the CPU.
At each save iteration (--save_iterations, --checkpoint_iterations and the
last iteration) it writes `point_cloud/iteration_N/point_cloud.ply` and
`chkpntN.npz` under the model path; at the end, `train_report.json` there:
the losses, event counts and times, n_static/n_dynamic after each event,
the GT cache's decoder ("native" libpng or "pil"), hits and bytes, the
kernels' launch counts and the host clock per iteration.

--port N (with --ip, default 127.0.0.1) serves the live SIBR viewer
(`viewer.NetworkViewer`) between steps; 0, the default, disables it.
--debug writes `debug/nan_snapshot_N.npz` under the model path when a step
produces NaNs. The tile shape, depth sort and tight cull come from the JAX
CLI's EX4DGS_TILE, EX4DGS_EXACT_SORT and EX4DGS_TIGHT_CULL
(`KernelConfig.from_env`); a resume keeps the config its checkpoint
records.

Several ranks (one process each): --mesh_data D --mesh_gauss G trains D
cameras per iteration with the splats and tiles sharded over G
(parallel/step_dp.py) on D x G ranks, started by torchrun
(`torchrun --nproc_per_node N -m ex4dgs_tpu_torch.train ...`) or by the
JAX CLI's flags, one process each:

    python -m ex4dgs_tpu_torch.train ... --mesh_data 2 --coordinator \
        localhost:29500 --num_processes 2 --process_id {0,1} \
        [--dist_backend gloo]

NCCL (the default on CUDA) needs a card per rank; --dist_backend gloo runs
several ranks on one card. Rank 0 alone writes the model path's files;
the report then carries every rank's checkpoint digests
("rank_digests"). The JAX CLI's --backend (its Pallas/jnp switch) has no
counterpart: the port always composites with its kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time


def _add_dataclass_args(parser, cls):
    for f in dataclasses.fields(cls):
        if f.type in ("bool", bool):
            parser.add_argument(f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=None)
        else:
            ftype = {"int": int, "float": float, "str": str}.get(str(f.type), str)
            parser.add_argument(f"--{f.name}", type=ftype, default=None)


def parse_args(argv=None):
    from ..models.config import ModelConfig, OptimizationConfig

    parser = argparse.ArgumentParser(prog="python -m ex4dgs_tpu_torch.train")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--save_iterations", type=int, nargs="*", default=[])
    # reference flag alias: checkpoints save alongside PLYs in Trainer.save
    parser.add_argument("--checkpoint_iterations", type=int, nargs="*", default=[])
    parser.add_argument("--test_iterations", type=int, nargs="*", default=[])
    parser.add_argument("--ip", type=str, default="127.0.0.1",
                        help="live SIBR viewer listen address (train.py:377)")
    parser.add_argument("--port", type=int, default=0,
                        help="live viewer port; 0 disables the viewer (reference default 6009)")
    parser.add_argument("--debug", action="store_true",
                        help="dump a state snapshot when a step produces NaNs")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to train on (default cuda)")
    parser.add_argument("--mesh_data", type=int, default=1,
                        help="data-parallel mesh axis (cameras per step)")
    parser.add_argument("--mesh_gauss", type=int, default=1,
                        help="model-parallel mesh axis (splat + tile sharding)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-process: rank 0's address host:port")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--dist_backend", type=str, default=None,
                        help="nccl (default on cuda) | gloo (default on cpu; several ranks "
                             "on one card)")
    _add_dataclass_args(parser, ModelConfig)
    _add_dataclass_args(parser, OptimizationConfig)
    return parser, parser.parse_args(argv)


def main(argv=None) -> int:
    parser, args = parse_args(argv)
    from .. import kernels, resolve_device
    from ..models.config import ModelConfig, OptimizationConfig, load_configs, overlay_json

    import torch
    import torch.distributed as dist

    from ..runtime.distributed import initialize

    # raises before anything is read without CUDA; joins the job first
    joined = not dist.is_initialized()
    dist_info = initialize(args.coordinator, args.num_processes, args.process_id,
                           device=args.device, backend=args.dist_backend)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist_info["process_count"] > 1:
        print(f"distributed: {dist_info}", flush=True)
    mesh = None
    if args.mesh_data * args.mesh_gauss > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh_data * args.mesh_gauss, data=args.mesh_data,
                         gauss=args.mesh_gauss, device=dev)
    rank0 = mesh is None or mesh.rank == 0
    cfg, opt = load_configs(args.config) if args.config else (ModelConfig(), OptimizationConfig())
    overrides = {k: v for k, v in vars(args).items() if v is not None}
    cfg = overlay_json(cfg, {k: v for k, v in overrides.items()
                             if k in {f.name for f in dataclasses.fields(ModelConfig)}})
    opt = overlay_json(opt, {k: v for k, v in overrides.items()
                             if k in {f.name for f in dataclasses.fields(OptimizationConfig)}})
    if not cfg.source_path:
        parser.error("--source_path is required")
    model_path = cfg.model_path or os.path.join("output", os.path.basename(cfg.source_path))
    os.makedirs(model_path, exist_ok=True)
    if rank0:
        with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
            json.dump({**dataclasses.asdict(cfg), **dataclasses.asdict(opt)}, f, indent=1)

    from ..data.scene import Scene
    from ..io.checkpoint import digest, load_checkpoint
    from ..kernel_config import KernelConfig
    from ..models.density import push
    from .trainer import Trainer, pipelined

    t0 = time.perf_counter()
    scene = Scene(cfg, model_path=model_path, save_input=rank0)
    scene_s = time.perf_counter() - t0
    model = opt_state = None
    # the JAX CLI's kernel knobs from the environment (EX4DGS_TILE,
    # EX4DGS_EXACT_SORT, EX4DGS_TIGHT_CULL); a checkpoint's recorded config
    # takes its place on a resume
    kernel = KernelConfig.from_env()
    if args.start_checkpoint:
        hm, start_it, extra = load_checkpoint(args.start_checkpoint)
        model, opt_state = push(hm, cfg, device=dev)
        if "kernel_config" in extra:
            kernel = KernelConfig.from_dict(json.loads(str(extra["kernel_config"])))

    gui = None
    if args.port and rank0:
        from ..viewer import NetworkViewer

        gui = NetworkViewer(args.ip, args.port, device=dev)
        try:
            print(f"viewer listening on {args.ip}:{gui.init()}", flush=True)
        except OSError as e:
            print(f"viewer disabled: {e}", flush=True)
            gui.close()
            gui = None

    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, opt, scene, model=model, opt_state=opt_state, seed=args.seed,
                      test_iterations=tuple(args.test_iterations), kernel=kernel,
                      debug_snapshot_dir=(os.path.join(model_path, "debug")
                                          if args.debug else None),
                      gui=gui, device=dev, mesh=mesh)
    init_s = time.perf_counter() - t0
    if args.start_checkpoint:
        trainer.iteration = start_it
        if "sample_len" in extra:
            trainer.sample_len = float(extra["sample_len"])
            scene.set_sampling_len(trainer.sample_len, sample_every=cfg.sample_every)

    save_at = sorted(set(args.save_iterations) | set(args.checkpoint_iterations)
                     | {opt.iterations})

    def progress(it, loss, psnr_val):
        if args.quiet or not rank0:
            return
        print(f"[{it}/{opt.iterations}] loss={loss:.5f} psnr={psnr_val:.2f} "
              f"static={int(trainer.model.n_static())} "
              f"dynamic={int(trainer.model.n_dynamic())}", flush=True)

    runs, saved, save_ms, rank_digests = [], {}, [], {}
    try:
        for target in save_at:
            if trainer.iteration >= target:
                continue
            runs.append(trainer.train(iterations=target, progress=progress))
            print(f"[ITER {target}] saving", flush=True)
            t0 = time.perf_counter()
            saved[target] = digest(trainer.save(model_path, target))
            save_ms.append((time.perf_counter() - t0) * 1e3)
            if mesh is not None:
                rank_digests[target] = [None] * dist.get_world_size()
                dist.all_gather_object(rank_digests[target], saved[target])
        gt_cache = trainer.prefetcher.stats()
    finally:
        trainer.close()
        if gui is not None:
            gui.close()

    iter_ms = [ms for r in runs for ms in r["iter_ms"]]
    first = trainer.iteration - len(iter_ms) + 1
    events_at = {it for r in runs for it in r["event_iterations"]}
    quiet_ms = [ms for i, ms in enumerate(iter_ms, first) if i not in events_at]
    report = {
        "device": str(dev),
        "scene_s": scene_s,
        "init_s": init_s,
        "save_ms": save_ms,
        "iterations": [first, trainer.iteration],
        "loss": [x for r in runs for x in r["loss"]],
        "psnr": [x for r in runs for x in r["psnr"]],
        "timestamps": [x for r in runs for x in r["timestamps"]],
        "test_reports": [rep for r in runs for rep in r.get("test_reports", [])],
        "iter_ms": iter_ms,
        "pipeline": pipelined(),
        "ms_per_iteration": statistics.mean(iter_ms) if iter_ms else None,
        "ms_per_iteration_without_events": statistics.mean(quiet_ms) if quiet_ms else None,
        "event_iterations": sorted(events_at),
        "event_counts": trainer.event_counts,
        "event_ms": trainer.event_ms,
        "pull_ms": trainer.pull_ms,
        "push_ms": trainer.push_ms,
        "event_log": trainer.event_log,
        "steps": trainer.steps,
        "overflow_retries": trainer.overflow_count,
        "graph_calls": trainer.graph_calls,
        "graph_replay_share": trainer.replay_share,
        "test_renders": trainer.test_renders,
        "gui_renders": trainer.gui_renders,
        "capacity": trainer.capacity,
        "gt_cache": gt_cache,
        "kernel_launches": dict(kernels.launches),
        "saved": saved,
        "distributed": dist_info,
        "mesh": None if mesh is None else mesh.shape,
        "rank_digests": rank_digests,
    }
    if rank0:
        with open(os.path.join(model_path, "train_report.json"), "w") as f:
            json.dump(report, f, indent=1)
    if joined and dist.is_initialized():
        dist.destroy_process_group()
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
