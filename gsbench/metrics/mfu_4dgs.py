"""A 4D Gaussian Splatting training step's % of the float32 peak
(`mfu_4dgs.train_step`): the FLOPs of the traced steps by the family's own
count (`counts_fourdgs.step_flops`: compositing forward and backward, the
slice, the projection, the loss and Adam over every view) over their time
in the window. None in a cell whose census is not 4DGS's."""
from gsbench import counts_fourdgs
from gsbench.readers import mfu


def read(run):
    if run["kind"] != "train" or not run.get("profile"):
        return None
    if "gaussians" not in run["work"]()[0]:
        return None
    return mfu(run, counts_fourdgs.step_flops)
