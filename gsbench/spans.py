"""What the `<layer>_host_ms` readers share: the host ms per outermost call
of one of the program's layer spans (`ex4dgs.<layer>`), from the program's
span record (`ex4dgs_tpu_torch.runtime.profiling.span_summary`). The
record fills only while a profiler runs, so in a traced run it holds the
traced calls (`trace.profile_calls`) and nothing else. A replayed training
step (a CUDA graph) opens no layer span, so only the render cells list
these metrics."""
from __future__ import annotations


def host_ms(run: dict, layer: str):
    """The span `ex4dgs.<layer>`'s total host ms per outermost call (a
    `train_step` or a `render`) over the traced calls, or None: an untraced
    run, a record with no outermost call, a layer the cell does not run, or
    a program that records no spans."""
    if not run.get("profile"):
        return None
    from ex4dgs_tpu_torch.runtime import profiling

    summary = getattr(profiling, "span_summary", None)
    if summary is None:
        return None
    found = summary()
    row = found["spans"].get(f"ex4dgs.{layer}")
    if not found["calls"] or row is None:
        return None
    return row["total_ms_per_call"]
