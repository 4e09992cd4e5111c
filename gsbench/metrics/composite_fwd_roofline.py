"""Kernel A (composite_fwd_kernel): % of its device time that the least
time for the forward compositing work of the traced calls takes."""
from gsbench import counts
from gsbench.readers import roofline


def read(run):
    training = run["kind"] == "train"
    return roofline(run, "composite_fwd_kernel", lambda w: counts.composite_fwd_work(
        w["pairs"], w["instances"], w["static"] + w["dynamic"], w["pixels"], training))
