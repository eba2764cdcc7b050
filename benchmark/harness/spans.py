"""The program's spans, read from a traced run's device operations
(`run.trace.ops`, harness/trace.py).

The program marks each of its spans on the device with two empty kernels,
`ga_span__<span>__b` where it opens and `ga_span__<span>__e` where it closes
(`train::decode` is spelled `train_decode`). A CUDA graph replays them with
the step's other kernels, so they are in the trace of every replayed step.
Here the markers are paired by name, as a stack (nested spans and replayed
instances pair in order), and each instance, from its begin marker's start
to its end marker's end, is measured against the other operations: busy,
the time in which some operation other than a marker ran; idle, the time
in which no operation at all ran. A trace without markers (a program that
sets none) or with one left unpaired (but for lost first kernels,
`pair`) reads None. Nothing of the program is
imported: the markers' names are the contract.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Optional, Tuple

MARKER = re.compile(r"ga_span__(\w+)__([be])")


def pair(ops) -> Optional[Dict[str, List[Tuple[float, float]]]]:
    """{span: [(start us, end us)] in order} from the markers among `ops`
    [(name, start us, duration us)]; None when there is no marker or one
    is unpaired. The profiler can lose the first kernels of its trace
    (those that start right after the profiler's own start): an end marker
    that comes before any begin marker of its span opens at the trace's
    first operation."""
    open_: Dict[str, List[float]] = {}
    out: Dict[str, List[Tuple[float, float]]] = {}
    ops = sorted(ops, key=lambda o: o[1])
    for name, t, d in ops:
        m = MARKER.fullmatch(name)
        if m is None:
            continue
        key, edge = m.groups()
        if edge == "b":
            open_.setdefault(key, []).append(t)
        elif open_.get(key):
            out.setdefault(key, []).append((open_[key].pop(), t + d))
        elif key not in open_:
            open_[key] = []
            out.setdefault(key, []).append((ops[0][1], t + d))
        else:
            return None
    if not out or any(open_.values()):
        return None
    for v in out.values():
        v.sort()
    return out


class Union:
    """The union of a set of intervals, and how much of [a, b] it covers."""

    def __init__(self, intervals: Iterable[Tuple[float, float]]):
        merged: List[List[float]] = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.cum = [0.0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def within(self, a: float, b: float) -> float:
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if j <= i:
            return 0.0
        return (self.cum[j] - self.cum[i] - max(0.0, a - self.starts[i])
                - max(0.0, self.ends[j - 1] - b))


def read(trace):
    """-> (spans as `pair` gives them, or None; the union of the non-marker
    operations; the union of all operations), computed once per trace."""
    got = getattr(trace, "_program_spans", None)
    if got is None:
        ops = trace.ops
        work = Union((t, t + d) for name, t, d in ops if not MARKER.fullmatch(name))
        every = Union((t, t + d) for _, t, d in ops)
        got = (pair(ops), work, every)
        trace._program_spans = got
    return got


def _key(name: str) -> str:
    return name.replace("::", "_")


def busy_ms(trace, names) -> Optional[float]:
    """Device busy ms summed over every instance of each span in `names`
    (program names, `train::decode`); None unless each has instances."""
    spans, work, _ = read(trace)
    if spans is None or any(_key(n) not in spans for n in names):
        return None
    return sum(work.within(a, b) for n in names for a, b in spans[_key(n)]) / 1e3


def idle_ms(trace, name: str) -> Optional[float]:
    """Ms inside the instances of span `name` in which the device ran no
    operation, summed; None without instances."""
    spans, _, every = read(trace)
    if spans is None or _key(name) not in spans:
        return None
    return sum((b - a) - every.within(a, b) for a, b in spans[_key(name)]) / 1e3


# the spans of each layer that the per-layer metrics read
DECODE_TRAIN = ("train::decode", "train::decode_bwd")
RASTER_FWD = ("render::projection", "render::binning", "render::blend", "render::untile")
RASTER_TRAIN = RASTER_FWD + ("render::blend_bwd", "render::scatter_bwd")
OPTIMIZER = ("train::optimizer",)


def per_step(run, names) -> Optional[float]:
    """busy_ms of `names` per traced training step."""
    if run.kind != "train" or run.trace is None or not getattr(run.trace, "steps", 0):
        return None
    ms = busy_ms(run.trace, names)
    return None if ms is None else ms / run.trace.steps


def per_call(run, names) -> Optional[float]:
    """busy_ms of `names` per traced render call."""
    if run.kind != "render" or run.trace is None or not getattr(run.trace, "calls", 0):
        return None
    ms = busy_ms(run.trace, names)
    return None if ms is None else ms / run.trace.calls
