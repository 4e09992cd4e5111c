"""The peak of the device memory the program allocated, from the process's
start to the window's end (torch.cuda.max_memory_allocated), in GiB."""


def read(run):
    return run["memory_peak_bytes"] / 2**30
