"""call_gap_ms.render: the time per traced render call in which the device
ran nothing inside the program's span `render::call` (from the call's
first marker to its last, both launched on the call's stream): the device
waiting on the program's launch path. Read from the marker kernels in the
device trace (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    if run.kind != "render" or run.trace is None or not getattr(run.trace, "calls", 0):
        return None
    ms = spans.idle_ms(run.trace, "render::call")
    return None if ms is None else ms / run.trace.calls
