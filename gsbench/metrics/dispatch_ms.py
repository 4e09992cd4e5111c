"""Host ms of the entry point's call, from the call to its return with no
sync, over the window's calls (`dispatch_ms.train`, `dispatch_ms.render`)."""
from gsbench.readers import dispatch_ms


def read(run):
    return dispatch_ms(run)
