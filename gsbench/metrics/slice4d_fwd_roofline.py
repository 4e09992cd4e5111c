"""The forward slicing kernel (slice4d_fwd_kernel, 4D Gaussian Splatting):
% of its device time that the least time for the traced steps' slicing
work takes (`counts_fourdgs.slice_fwd_work` over every Gaussian of every
view)."""
from gsbench import counts_fourdgs
from gsbench.readers import roofline


def read(run):
    return roofline(run, "slice4d_fwd_kernel",
                    lambda w: counts_fourdgs.slice_fwd_work(w["gaussians"]))
