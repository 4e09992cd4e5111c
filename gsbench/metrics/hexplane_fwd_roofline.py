"""The forward HexPlane kernel (hexplane_fwd_kernel, 4D-GS): % of its
device time that the least time for the traced steps' field work takes
(`counts_hexplane.field_fwd_work` over every deformed Gaussian of every
view). None in a cell whose census is not 4D-GS's."""
from gsbench import counts_hexplane
from gsbench.readers import roofline


def read(run):
    if not run.get("profile") or "deformed" not in run["work"]()[0]:
        return None
    return roofline(run, "hexplane_fwd_kernel", counts_hexplane.field_fwd_work)
