"""Kernel B (composite_bwd_kernel): % of its device time that the least
time for the backward compositing work of the traced steps takes."""
from gsbench import counts
from gsbench.readers import roofline


def read(run):
    return roofline(run, "composite_bwd_kernel", lambda w: counts.composite_bwd_work(
        w["pairs"], w["instances"], w["static"] + w["dynamic"], w["pixels"]))
