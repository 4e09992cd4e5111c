"""The backward HexPlane kernel (hexplane_bwd_kernel, 4D-GS): % of its
device time that the least time for the traced steps' field gradients
takes (`counts_hexplane.field_bwd_work`). None in a cell whose census is
not 4D-GS's."""
from gsbench import counts_hexplane
from gsbench.readers import roofline


def read(run):
    if not run.get("profile") or "deformed" not in run["work"]()[0]:
        return None
    return roofline(run, "hexplane_bwd_kernel", counts_hexplane.field_bwd_work)
