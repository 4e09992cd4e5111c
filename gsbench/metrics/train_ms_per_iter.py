"""The window's time over the train_step calls completed in it; the window
ends in a synchronize."""
from gsbench.readers import per_call_s


def read(run):
    return 1e3 * per_call_s(run) if run["kind"] == "train" else None
