"""Host ms per call in the span `ex4dgs.temporal`, the temporal query
(`point_data_at_t`) (`temporal_host_ms.render`)."""
from gsbench.spans import host_ms


def read(run):
    return host_ms(run, "temporal")
