"""Approximate mean 3-nearest-neighbour squared distances.

Counterpart of `ex4dgs_tpu/ops/knn.py`, reproducing its search rather than an
exact KNN, so the initial scales of `create_from_pcd` agree with the JAX
package: candidates are the +-window neighbours in three axis-permuted 30-bit
Morton orders, deduplicated, then exact distances and the k smallest. The
JAX code does uint32 arithmetic; here it is int64 with the same masks (every
product stays below 2^63, so the masked low 32 bits are identical).
"""
from __future__ import annotations

import torch

_PERMS = ((0, 1, 2), (1, 2, 0), (2, 0, 1))


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (Morton interleave prep)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _quantize(points: torch.Tensor) -> torch.Tensor:
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.zeros_like(hi))
    return torch.clamp((points - lo) * scale * 1023.0, 0.0, 1023.0).to(torch.int64)


def morton_codes(points: torch.Tensor, perm=(0, 1, 2)) -> torch.Tensor:
    """30-bit Morton codes (int64) of [P, 3] points normalized over their bbox."""
    q = _quantize(points)
    return _codes(q, perm)


def _codes(q, perm):
    return ((_expand_bits(q[:, perm[0]]) << 2)
            | (_expand_bits(q[:, perm[1]]) << 1)
            | _expand_bits(q[:, perm[2]])) & 0xFFFFFFFF


def mean_knn_dist2(points: torch.Tensor, k: int = 3, window: int = 64,
                   row_chunk: int = 8192) -> torch.Tensor:
    """Mean squared distance to the (approximate) k nearest neighbours of
    each of the [P, 3] points. Distances are evaluated in chunks of
    `row_chunk` points so the [rows, 6*window, 3] candidate gather stays
    small."""
    P = points.shape[0]
    dev = points.device
    q = _quantize(points)
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])
    ar = torch.arange(P, device=dev)

    cand = []
    for perm in _PERMS:
        order = torch.argsort(_codes(q, perm), stable=True)
        rank = torch.empty_like(order)
        rank[order] = ar
        nbr_rank = rank[:, None] + offs[None, :]
        ok = (nbr_rank >= 0) & (nbr_rank < P)
        nbr = order[nbr_rank.clamp(0, P - 1)]
        cand.append(torch.where(ok, nbr, torch.full_like(nbr, P)))  # P = none
    cand = torch.cat(cand, dim=1)  # [P, 3*2W]

    out = torch.empty(P, dtype=points.dtype, device=dev)
    for r0 in range(0, P, row_chunk):
        c = torch.sort(cand[r0:r0 + row_chunk], dim=1).values
        dup = torch.zeros_like(c, dtype=torch.bool)
        dup[:, 1:] = c[:, 1:] == c[:, :-1]
        valid = (c < P) & ~dup
        nbr_pts = points[c.clamp(0, P - 1)]  # [R, C, 3]
        d2 = torch.sum((nbr_pts - points[r0:r0 + row_chunk, None, :]) ** 2, dim=-1)
        d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
        knn = torch.topk(d2, k, dim=1, largest=False).values
        finite = torch.isfinite(knn)
        out[r0:r0 + row_chunk] = (
            torch.where(finite, knn, torch.zeros_like(knn)).sum(-1)
            / finite.sum(-1).clamp_min(1))
    return out
