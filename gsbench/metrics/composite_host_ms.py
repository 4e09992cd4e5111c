"""Host ms per call in the span `ex4dgs.composite`, pack, kernel A and
untiling (`composite_host_ms.render`)."""
from gsbench.spans import host_ms


def read(run):
    return host_ms(run, "composite")
