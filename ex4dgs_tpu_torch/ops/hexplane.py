"""4D-GS's HexPlane field (Wu et al., CVPR 2024): bilinear samples of six
feature planes per scale at a point's (x, y, z, t), their product per scale,
the scales concatenated. The kernel pair `csrc/hexplane_fwd.cu` /
`csrc/hexplane_bwd.cu`, their plain versions, and the autograd function the
deformation calls.

Per point with coordinates c = (x, y, z, t) (x, y, z normalised to the
field's box, [-1, 1] inside it; t as given) and per scale s, plane k of the
pairs PAIRS = (x,y), (x,z), (x,t), (y,z), (y,t), (z,t) holds C channels in
a tensor [C, R_b, R_a] for its pair (a, b). Its sample is F.grid_sample's
with align_corners=True and border padding:

  u_a = clamp((c_a + 1) / 2 (R_a - 1), 0, R_a - 1),   i_a = min(floor(u_a), R_a - 2),
  w_a = u_a - i_a   (the same along b),
  S_k = (1 - w_b) ((1 - w_a) P[j, i] + w_a P[j, i + 1])
        + w_b ((1 - w_a) P[j + 1, i] + w_a P[j + 1, i + 1])   with i = i_a, j = i_b,
  f_s = S_0 S_1 ... S_5 (channel by channel),   f = (f_0, f_1, ...)   [P, C x scales].

The backward is the product rule: dL/dS_k = dL/df_s times the other five
samples; the four corners of plane k get it times their weights, and the
coordinates get it times dS_k/du (the difference of the corners along the
axis) times (R - 1) / 2, which is 0 where u was clamped (at or past the
border, as grid_sample's gradient is). The kernel sums each plane cell's
terms in fixed point, so its gradients repeat bit for bit.

On CPU tensors `HexPlane` runs the plain versions; on CUDA tensors it
launches the kernels (`kernels.hexplane_fwd`, `kernels.hexplane_bwd`) and
raises where they cannot run. Float32 throughout.
"""
from __future__ import annotations

import torch

from .. import kernels

PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# The kernels against the plain versions, in float32. The forward rounds
# the same terms in the same order (csrc/hexplane_common.cuh): the same
# bits, held to HEX_RTOL of the largest feature, a few ulps, should nvcc
# ever fuse. The backward sums the coordinates' 16 channels in another
# order (a few ulps of a sum that cancels), and each plane cell's terms in
# 64-bit fixed point (the same bits at every launch; csrc/hexplane_bwd.cu),
# where the plain version adds them in float32 with index_add_: a cell's
# sum of up to ~10^5 terms of both signs rounds by ~sqrt(n) ulps of its
# terms, held to HEX_BWD_RTOL of the plane's largest gradient. bfloat16
# (ulp 4e-3) misses both by far.
HEX_RTOL = 2e-6
HEX_BWD_RTOL = 1e-4


def plane_keys(n_scales: int) -> list[str]:
    """The planes' parameter names, scale-major: grid.<scale>.<plane>."""
    return [f"grid.{s}.{k}" for s in range(n_scales) for k in range(len(PAIRS))]


def _axis(c, R: int):
    """(i0, w, du/dc) along one axis of R cells: u clamped to [0, R - 1],
    i0 = min(floor(u), R - 2), w = u - i0; du/dc = (R - 1) / 2 strictly
    inside, 0 where u was clamped."""
    u = (c + 1.0) * 0.5 * (R - 1)
    inside = (u > 0) & (u < R - 1)
    u = torch.clamp(torch.nan_to_num(u, nan=0.0), 0.0, float(R - 1))
    i0 = torch.clamp(torch.floor(u), 0, R - 2)
    dudc = torch.where(inside, torch.full_like(u, 0.5 * (R - 1)), torch.zeros_like(u))
    return i0.long(), u - i0, dudc


def _corners(plane, ia, ib):
    """The four corners [P, C] (v00 at (j, i), v01 at (j, i + 1), v10 at
    (j + 1, i), v11 at (j + 1, i + 1)) and their flat indices."""
    C, Rb, Ra = plane.shape
    flat = plane.reshape(C, Rb * Ra)
    idx = [ib * Ra + ia, ib * Ra + ia + 1, (ib + 1) * Ra + ia, (ib + 1) * Ra + ia + 1]
    return [flat[:, i].T for i in idx], idx


def _samples(coords, planes):
    """Per plane: (S [P, C], corners, flat indices, (w_a, w_b), (du_a,
    du_b), (a, b))."""
    out = []
    for n, plane in enumerate(planes):
        a, b = PAIRS[n % len(PAIRS)]
        _, Rb, Ra = plane.shape
        ia, wa, da = _axis(coords[:, a], Ra)
        ib, wb, db = _axis(coords[:, b], Rb)
        (v00, v01, v10, v11), idx = _corners(plane, ia, ib)
        wa_, wb_ = wa[:, None], wb[:, None]
        s = (1 - wb_) * ((1 - wa_) * v00 + wa_ * v01) + wb_ * ((1 - wa_) * v10 + wa_ * v11)
        out.append((s, (v00, v01, v10, v11), idx, (wa_, wb_), (da, db), (a, b)))
    return out


def hexplane_plain(coords, planes):
    """The forward kernel's features f [P, C x scales] in plain torch:
    coords [P, 4], planes scale-major, six a scale, each [C, R_b, R_a]."""
    parts = _samples(coords, planes)
    feats = []
    for s in range(0, len(parts), len(PAIRS)):
        f = torch.ones_like(parts[s][0])
        for k in range(len(PAIRS)):
            f = f * parts[s + k][0]
        feats.append(f)
    return torch.cat(feats, -1)


def hexplane_bwd_plain(coords, planes, g_f):
    """The backward kernel's gradients in plain torch: (coords' [P, 4],
    each plane's, shaped as it is) from the features' cotangent g_f."""
    parts = _samples(coords, planes)
    g_coords = torch.zeros_like(coords)
    g_planes = []
    C = planes[0].shape[0]
    n = len(PAIRS)
    for s in range(0, len(parts), n):
        g = g_f[:, (s // n) * C:(s // n + 1) * C]
        samples = [parts[s + k][0] for k in range(n)]
        for k in range(n):
            others = torch.ones_like(g)
            for j in range(n):
                if j != k:
                    others = others * samples[j]
            g_s = g * others
            _, (v00, v01, v10, v11), idx, (wa, wb), (da, db), (a, b) = parts[s + k]
            plane = planes[s + k]
            gp = torch.zeros_like(plane).reshape(C, -1)
            for i, w in zip(idx, ((1 - wa) * (1 - wb), wa * (1 - wb), (1 - wa) * wb, wa * wb)):
                gp.index_add_(1, i, (g_s * w).T)
            g_planes.append(gp.view_as(plane))
            du_a = (1 - wb) * (v01 - v00) + wb * (v11 - v10)
            du_b = (1 - wa) * (v10 - v00) + wa * (v11 - v01)
            g_coords[:, a] += (g_s * du_a).sum(-1) * da
            g_coords[:, b] += (g_s * du_b).sum(-1) * db
    return g_coords, g_planes


class HexPlane(torch.autograd.Function):
    """The HexPlane field as one autograd node: the kernels on CUDA tensors,
    the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, coords, *planes):
        ctx.save_for_backward(coords, *planes)
        if coords.device.type == "cpu":
            return hexplane_plain(coords, planes)
        return kernels.hexplane_fwd(coords, planes)

    @staticmethod
    def backward(ctx, g_f):
        coords, *planes = ctx.saved_tensors
        g_f = g_f.contiguous()
        if coords.device.type == "cpu":
            g_coords, g_planes = hexplane_bwd_plain(coords, planes, g_f)
        else:
            g_coords, g_planes = kernels.hexplane_bwd(coords, planes, g_f)
        return (g_coords, *g_planes)


def hexplane(coords, planes):
    """f [P, C x scales] of the points coords [P, 4] (normalised x, y, z and
    t) in the planes (scale-major, six a scale, [C, R_b, R_a] each)."""
    return HexPlane.apply(coords, *planes)
