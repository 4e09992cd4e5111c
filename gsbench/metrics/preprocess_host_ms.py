"""Host ms per call in the span `ex4dgs.preprocess`, preprocess: cov3d, EWA
projection, SH to RGB (`preprocess_host_ms.render`)."""
from gsbench.spans import host_ms


def read(run):
    return host_ms(run, "preprocess")
