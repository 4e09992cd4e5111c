"""The window's time over the frames delivered to the host in it."""
from gsbench.readers import per_call_s


def read(run):
    return 1e3 * per_call_s(run) if run["kind"] == "render" else None
