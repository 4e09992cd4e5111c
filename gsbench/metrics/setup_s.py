"""Seconds from the process's start to the window's first call: imports,
CUDA context, kernel builds (the first run in a checkout), the scene, the
traffic's set-up and warm-up."""


def read(run):
    return run["setup_s"]
