"""The (data, gauss) layout of the ranks of a `torch.distributed` job.

Counterpart of `ex4dgs_tpu/parallel/mesh.py`. One process per rank, each
with one device; rank r = d * gauss + g sits at data index d and gauss
index g. Axes:

  data  - cameras: each data rank renders and differentiates its own
          camera; the parameter gradients are averaged over this axis.
  gauss - Gaussians and tiles: the per-Gaussian preprocess runs on a 1/G
          slice of the splats on each gauss rank and the projected rows are
          all-gathered; the compositing runs on a slab of tile rows per
          gauss rank and the tile blocks are all-gathered.

`data_group` holds the ranks of this rank's gauss index (varying d),
`gauss_group` those of its data index (varying g). Without an initialised
process group the mesh is (1, 1) and both groups are None (a group of one
rank: every collective is the identity).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    gauss: int
    rank: int
    device: torch.device
    data_group: object = None
    gauss_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "gauss": self.gauss}

    @property
    def data_index(self) -> int:
        return self.rank // self.gauss

    @property
    def gauss_index(self) -> int:
        return self.rank % self.gauss


def make_mesh(n_devices: int | None = None, data: int | None = None,
              gauss: int | None = None, device=None) -> Mesh:
    """The (data, gauss) mesh of the job's ranks on `device` (cuda unless
    told otherwise: this process's current CUDA device). n_devices defaults
    to the world size and must equal it; data and gauss default as JAX's
    make_mesh: all ranks on the data axis unless gauss is given.

    Every rank must call it, with the same arguments: it creates the axis
    groups, and `new_group` is collective."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if data is None and gauss is None:
        data, gauss = n_devices, 1
    elif data is None:
        data = n_devices // gauss
    elif gauss is None:
        gauss = n_devices // data
    if data * gauss != n_devices:
        raise ValueError(f"a (data, gauss) = ({data}, {gauss}) mesh of {n_devices} ranks")
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a job of {world}: start one process "
                         "per rank (runtime.distributed.initialize)")
    if not dist.is_initialized():
        return Mesh(data=data, gauss=gauss, rank=0, device=dev)
    rank = dist.get_rank()
    data_group = gauss_group = None
    for g in range(gauss):  # new_group is collective: every rank makes every group
        grp = dist.new_group([d * gauss + g for d in range(data)])
        if rank % gauss == g:
            data_group = grp
    for d in range(data):
        grp = dist.new_group([d * gauss + g for g in range(gauss)])
        if rank // gauss == d:
            gauss_group = grp
    return Mesh(data=data, gauss=gauss, rank=rank, device=dev, data_group=data_group,
                gauss_group=gauss_group)
