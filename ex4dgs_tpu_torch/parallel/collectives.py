"""The collectives of the sharded paths, over `torch.distributed` process
groups, on gloo and NCCL alike.

Sums and maxima over ranks are one all-reduce each. The backends' ring and
tree all-reduces reduce every element once and hand the result to every
rank, so the ranks of a group hold the same bits and their models stay
bit-equal; tests/test_torch_parallel_step.py and chip_smoke.py check that
by digest. A group of one rank (a mesh axis of size 1, or no initialised
process group) costs nothing: every collective is the identity there, so
one process runs the sharded code at mesh (1, 1) with `train_step`'s
arithmetic.

`GatherRows` is the all-gather along dim 0 with its gradient: each rank
keeps its own rows of the cotangent, summed over the group when each rank's
cotangent is a part of the whole (rows that feed a different slab on each
rank), and as it is when every rank holds the same whole (a frame that
every rank turns into the same loss).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """[t of rank 0, t of rank 1, ...] over the group; every rank's t has
    the same shape and dtype. Bool tensors travel as uint8, and every
    tensor flat."""
    if group_size(group) == 1:
        return [t]
    if t.dtype == torch.bool:
        return [p.bool() for p in all_gather(t.to(torch.uint8), group)]
    src = t.detach().reshape(-1).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.view(t.shape) for p in parts]


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if group_size(group) == 1:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def group_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of t over the group's ranks."""
    return _all_reduce(t, dist.ReduceOp.SUM, group)


def group_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of t over the group's ranks."""
    return _all_reduce(t, dist.ReduceOp.MAX, group)


def broadcast_(t: torch.Tensor, src: int = 0) -> None:
    """Overwrite t with world rank src's t (bool tensors travel as uint8)."""
    if group_size() == 1:
        return
    if t.dtype == torch.bool:
        u = t.to(torch.uint8)
        dist.broadcast(u, src=src)
        t.copy_(u.bool())
    else:
        dist.broadcast(t, src=src)


class GatherRows(torch.autograd.Function):
    """cat(all_gather(x), 0) with its gradient: rank r's rows of the
    cotangent, summed over the group first unless `replicated` (every rank
    then holds the whole cotangent already; summing would count the loss
    once per rank)."""

    @staticmethod
    def forward(ctx, x, group, replicated):
        ctx.group, ctx.replicated = group, replicated
        ctx.rows, ctx.rank = x.shape[0], group_rank(group)
        return torch.cat(all_gather(x, group), 0)

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated:
            g = group_sum(g, ctx.group)
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None, None


def gather_rows(x: torch.Tensor, group=None, replicated: bool = False) -> torch.Tensor:
    """The group's x concatenated along dim 0 in rank order; see GatherRows
    for its gradient. A tensor that needs no gradient is gathered plainly,
    and a group of one rank returns x itself."""
    if group_size(group) == 1:
        return x
    if x.requires_grad:
        return GatherRows.apply(x, group, replicated)
    return torch.cat(all_gather(x, group), 0)
