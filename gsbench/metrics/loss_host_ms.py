"""Host ms per call in the span `ex4dgs.loss`, the loss: L1, SSIM, flow hook,
regularizers (`loss_host_ms.train`; a render opens none)."""
from gsbench.spans import host_ms


def read(run):
    return host_ms(run, "loss")
