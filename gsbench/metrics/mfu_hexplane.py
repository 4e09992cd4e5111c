"""A 4D-GS training step's % of the float32 peak (`mfu_hexplane.train_step`):
the FLOPs of the traced steps by the family's own count
(`counts_hexplane.step_flops`: compositing forward and backward, the
HexPlane field, the deformation MLP, the activations and colour, the
projection, the loss, the regularizers and Adam over every view) over their
time in the window. None in a cell whose census is not 4D-GS's."""
from gsbench import counts_hexplane
from gsbench.readers import mfu


def read(run):
    if run["kind"] != "train" or not run.get("profile"):
        return None
    if "deformed" not in run["work"]()[0]:
        return None
    return mfu(run, counts_hexplane.step_flops)
