"""Host ms per call in the span `ex4dgs.binning`, binning: keys, depth sort,
tile ranges (`binning_host_ms.render`)."""
from gsbench.spans import host_ms


def read(run):
    return host_ms(run, "binning")
