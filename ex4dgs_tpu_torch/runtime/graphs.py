"""The port's entry points as CUDA graphs, one graph per entry point and card.

`train_step` and `train_step_4d` (entry "train_step", one graph between
them) and a no-gradient `render` (entry "render") run on CUDA through
`run`. The first call with a key runs eagerly (the warm-up), the second
captures the work and replays it, and every later call copies its inputs
into the graph's static buffers and replays it. The key is what a capture
bakes in: the caller builds it from its statics, the inputs' sizes and the
storage of every state tensor the work reads by address (`state_key`). The
host numbers a call changes (timestamps, learning rates) are staged on the
device each call (`stage_scalars`). A new key releases the entry's old
graph and its memory on that card; a training step's new key also releases
the card's render graph, so that no training run carries a render's
buffers into its step.

Inside a replay no Python runs, so no layer span opens; the stage and the
launch are spans of their own (`ex4dgs.graph.stage`, `ex4dgs.graph.replay`).
`kernels.graph_calls` counts how each entry's calls ran.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import kernels, upload
from .profiling import span

CAMERA_TENSORS = ("view", "proj", "campos", "tan_fovx", "tan_fovy")


class Graph:
    """The work of one key on one card: after its eager first call, the
    static input buffers, the captured graph, the outputs it keeps and the
    kernel launches it records."""

    def __init__(self, key: tuple):
        self.key = key
        self.graph = None
        self.inputs: list[torch.Tensor] | None = None
        self.scalars: torch.Tensor | None = None
        self.out = None
        self.launches: dict[str, int] = {}


_GRAPHS: dict[tuple[str, torch.device], Graph] = {}  # at most one per entry point and card
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def release(entry: str | None = None, dev: torch.device | None = None) -> None:
    """Drop the graphs of `entry` on card `dev` (every entry, every card
    where None), and with them their memory pools."""
    for k in [k for k in _GRAPHS if entry in (None, k[0]) and dev in (None, k[1])]:
        del _GRAPHS[k]


def state_key(obj) -> tuple:
    """Every tensor of a model or an optimizer state by field and name, with
    what a graph captured on it bakes in: its address, type and layout."""
    key = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        for name, x in (sorted(v.items()) if isinstance(v, dict) else [(None, v)]):
            key.append((f.name, name, x.data_ptr(), x.dtype, x.shape, x.stride())
                       if isinstance(x, torch.Tensor) else (f.name, name, x))
    return tuple(key)


def stage_scalars(ts, lrs: dict, out: torch.Tensor) -> torch.Tensor:
    """out [len(ts) + len(lrs)] on the device <- the times ts (one t, or a
    list of them) and the rates, in float32 (the host values' bits as the
    eager kernels would round them): one pinned copy that does not block,
    and a copy on the device of each t that is there."""
    ts = list(ts) if isinstance(ts, (list, tuple)) else [ts]
    on_device = [isinstance(t, torch.Tensor) and t.device.type != "cpu" for t in ts]
    host = torch.tensor([0.0 if dev_t else float(t) for t, dev_t in zip(ts, on_device)]
                        + [float(v) for v in lrs.values()], dtype=torch.float32)
    upload(host, out.device, out=out)
    for i, (t, dev_t) in enumerate(zip(ts, on_device)):
        if dev_t:
            out[i].copy_(t)
    return out


def card(dev: torch.device) -> torch.device:
    """dev with its index: the graphs are kept per card."""
    return torch.device("cuda", torch.cuda.current_device()) if dev.index is None else dev


def run(entry: str, dev: torch.device, key: tuple, inputs: list, ts: list, lrs: dict, body,
        result, kept=lambda out: out, releases: tuple = ()):
    """`entry`'s work as one CUDA graph on the card `dev`. body(inputs,
    scalars) runs the work on the input tensors (the caller's, or the
    graph's static copies of them) and the staged scalars (`stage_scalars`
    of ts and lrs) and returns its outputs; kept(outputs) is what the graph
    holds of a capture's outputs, and result(kept) a replay's result. The
    first call with a key runs body eagerly and releases the graphs of
    `releases` on the card too, the second captures it and replays, later
    calls stage and replay."""
    g = _GRAPHS.get((entry, dev))
    if g is None or g.key != key:
        for e in (entry, *releases):
            _GRAPHS.pop((e, dev), None)  # releases the old graph and its pool
        scalars = stage_scalars(ts, lrs, torch.empty(len(ts) + len(lrs), device=dev))
        out = body(inputs, scalars)
        _GRAPHS[(entry, dev)] = Graph(key)
        kernels.count_graph_call(dev, "eager", entry)
        return out
    with span("ex4dgs.graph.stage"):
        if g.graph is None:
            g.inputs = [torch.empty_like(x) for x in inputs]
            g.scalars = torch.empty(len(ts) + len(lrs), device=dev)
        for static, x in zip(g.inputs, inputs):
            static.copy_(x)
        stage_scalars(ts, lrs, g.scalars)
    if g.graph is None:
        capture(g, dev, lambda: kept(body(g.inputs, g.scalars)))
        kernels.count_graph_call(dev, "captures", entry)
    with span("ex4dgs.graph.replay"):
        g.graph.replay()
        kernels.replayed(g.launches)
        kernels.count_graph_call(dev, "replays", entry)
        return result(g.out)


def capture(g: Graph, dev: torch.device, run) -> None:
    """Capture run() (the work on g's static inputs) on a side stream
    ordered after the current one by events: no synchronize, so the capture
    reads nothing back either. Nothing runs until a replay. g keeps run()'s
    outputs."""
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    stream = _CAPTURE_STREAMS[dev]
    current = torch.cuda.current_stream(dev)
    stream.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), torch.cuda.stream(stream), kernels.capturing() as tally:
        # thread_local: another thread's CUDA calls (the trainer's prefetcher)
        # may go on while this one captures
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = run()
        finally:
            graph.capture_end()
    current.wait_stream(stream)
    g.graph, g.launches, g.out = graph, tally, out
