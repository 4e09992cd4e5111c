"""The backward slicing kernel (slice4d_bwd_kernel, 4D Gaussian
Splatting): % of its device time that the least time for the traced
steps' slicing gradients takes (`counts_fourdgs.slice_bwd_work`)."""
from gsbench import counts_fourdgs
from gsbench.readers import roofline


def read(run):
    return roofline(run, "slice4d_bwd_kernel",
                    lambda w: counts_fourdgs.slice_bwd_work(w["gaussians"]))
