"""Multi-process start-up and the host-side helpers of the sharded paths.

Counterpart of `ex4dgs_tpu/runtime/distributed.py`. `initialize()` starts
`torch.distributed` for one process per rank: from its arguments (the
training CLI's --coordinator/--num_processes/--process_id), else from
torchrun's RANK/WORLD_SIZE/MASTER_ADDR/LOCAL_RANK, else from
EX4DGS_NUM_PROCESSES; with one process and no coordinator it starts
nothing. The helpers keep host-side training state (RNG, camera order)
identical across ranks, which the sharded step relies on.

The backend is NCCL on CUDA and gloo with device="cpu". Gloo on CUDA is
taken only when asked for (backend="gloo", the CLI's --dist_backend gloo):
that is how several ranks share one card, which NCCL refuses. There is no
automatic switch: NCCL with two ranks on one card of a host raises, before
the job starts when torchrun's LOCAL_WORLD_SIZE exceeds the host's cards,
else once the job has started (`refuse_shared_cards`).
"""
from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None, backend: str | None = None,
               timeout: float = 600.0) -> dict:
    """Join the job, then return JAX's keys (process_index, process_count,
    local_devices, global_devices) and the backend used ("none" for one
    process without a coordinator).

    coordinator_address: "host:port" of rank 0's store (tcp), or a full
    init_method URL (e.g. "file:///path"). device: cuda unless told
    otherwise; on CUDA this process takes card LOCAL_RANK (else its process
    id) modulo the host's cards. timeout: seconds a collective may wait."""
    dev = resolve_device(device)
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", env.get("EX4DGS_NUM_PROCESSES", "1")))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", process_id))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        # torchrun says how many ranks share this host; refuse early then.
        local_ranks = env.get("LOCAL_WORLD_SIZE")
        if backend == "nccl" and local_ranks is not None and int(local_ranks) > cards:
            raise RuntimeError(_shared_card(f"{local_ranks} ranks share {cards} device(s) "
                                            "on this host"))
        torch.cuda.set_device(local_rank % cards)
    started = num_processes > 1 or coordinator_address is not None or "MASTER_ADDR" in env
    if started and not dist.is_initialized():
        if coordinator_address is None:
            init_method = "env://"
        elif "://" in coordinator_address:
            init_method = coordinator_address
        else:
            init_method = f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                                rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout))
        if dev.type == "cuda" and backend == "nccl":
            refuse_shared_cards(torch.cuda.current_device())
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {  # one device per process
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
        "backend": dist.get_backend() if dist.is_initialized() else "none",
    }


def _shared_card(what: str) -> str:
    return (f"NCCL needs a CUDA device of its own for each rank: {what}; pass "
            "--dist_backend gloo (backend='gloo') to run several ranks on one card")


def refuse_shared_cards(card: int) -> None:
    """Raise on every rank of the job (after leaving it) if two ranks hold
    the same card of the same host. The seats travel over a gloo group, so
    the check needs no NCCL communicator, which would fail on a shared
    card at the first collective."""
    seats = [None] * dist.get_world_size()
    group = dist.new_group(backend="gloo")
    dist.all_gather_object(seats, (socket.gethostname(), card), group=group)
    dist.destroy_process_group(group)
    shared = sorted({s for s in seats if seats.count(s) > 1})
    if shared:
        dist.destroy_process_group()
        raise RuntimeError(_shared_card(
            ", ".join(f"{seats.count(s)} ranks hold card {s[1]} of host {s[0]}"
                      for s in shared)))


def host_consistent_seed(seed: int) -> np.random.Generator:
    """Every rank must draw the same schedule randomness (densify split
    noise, camera shuffles) so that its host events stay in lockstep."""
    return np.random.default_rng(seed)


def shard_cameras_for_host(cameras: list, data_axis_size: int) -> list:
    """The cameras of this process's rows of the step's camera batch:
    process p takes [p * per, (p + 1) * per), per = len(cameras) // the
    process count (at least 1)."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    p = dist.get_rank() if dist.is_initialized() else 0
    per = max(1, len(cameras) // count)
    return cameras[p * per:(p + 1) * per]
