"""The pack VJP (csrc/pack_vjp.cu: pack_vjp_kernel_scatter, which puts the
live instances' cotangents in expansion order, and pack_vjp_kernel, the
segment sums; both names hold `pack_vjp_kernel`): % of their device time
that the least time for the traced calls' gradient reduction takes.

The count is what any implementation of the reduction must move, summed
over the census of the traced calls: each live instance's 16 cotangent
floats and its index (68 B), and each visible Gaussian's cum and counts
and its 16 gradient floats (72 B). No FLOPs are counted: it is bound by
bytes. The census counts visible Gaussians as `visible` (4D Gaussian
Splatting) or as `static` + `dynamic` (Ex4DGS)."""
from gsbench.readers import roofline

INSTANCE_BYTES = 16 * 4 + 4
VISIBLE_BYTES = 2 * 4 + 16 * 4


def pack_vjp_work(w: dict):
    """(FLOPs, bytes) of the census `w`'s pack VJP."""
    visible = w["visible"] if "visible" in w else w["static"] + w["dynamic"]
    return 0, INSTANCE_BYTES * w["instances"] + VISIBLE_BYTES * visible


def read(run):
    return roofline(run, "pack_vjp_kernel", pack_vjp_work)
