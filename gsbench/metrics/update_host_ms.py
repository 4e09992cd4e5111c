"""Host ms per call in the span `ex4dgs.update`, the update: mask, scrub,
RAdam, stat accumulators, overflow gate (`update_host_ms.train`; a render
opens none)."""
from gsbench.spans import host_ms


def read(run):
    return host_ms(run, "update")
