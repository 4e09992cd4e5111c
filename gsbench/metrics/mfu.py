"""The whole call's % of the float32 peak: the FLOPs of the traced calls
over their time in the window. A training step (`mfu.train_step`) counts
compositing forward and backward, per-splat stages and their gradients,
loss and RAdam; a frame (`mfu.render`) its per-splat stages and forward
compositing."""
from gsbench import counts
from gsbench.readers import mfu


def read(run):
    if run["kind"] == "train":
        return mfu(run, lambda w: counts.step_flops(
            w["pairs"], w["pixels"], w["static"], w["dynamic"], w["param_elements"]))
    return mfu(run, lambda w: counts.frame_flops(w["pairs"], w["pixels"], w["static"],
                                                 w["dynamic"]))
