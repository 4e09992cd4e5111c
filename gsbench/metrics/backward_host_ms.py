"""Host ms per call in the span `ex4dgs.backward`, autograd's backward, the
pack VJP and kernel B included (`backward_host_ms.train`; a render opens
none)."""
from gsbench.spans import host_ms


def read(run):
    return host_ms(run, "backward")
