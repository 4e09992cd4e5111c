"""% of a call's wall time in which the device ran nothing (the cell's
entry point: `idle_share.train`, `idle_share.render`)."""
from gsbench.readers import idle_share


def read(run):
    return idle_share(run)
