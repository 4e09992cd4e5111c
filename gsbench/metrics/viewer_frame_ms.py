"""The window's time over the frames delivered to the host in it, as
`frame_ms` reads it, kept per layer in a render cell whose host runs too
unsteadily between processes to hold it to a bound end to end."""
from gsbench.readers import per_call_s


def read(run):
    return 1e3 * per_call_s(run) if run["kind"] == "render" else None
