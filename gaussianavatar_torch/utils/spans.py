"""The program's spans: named ranges of its work that show in a profiler's
trace on the host and, on the card, on the device, where they survive
CUDA-graph replay.

`span(name, device)` opens `record_function(name)` (the host range) and,
when `device` is a CUDA device, launches an empty begin kernel on the
current stream as it opens and an end kernel as it closes
(`csrc/span_marks.cu`: `ga_span__train_decode__b` and `__e` for
"train::decode"). A CUDA graph captures the launches, so every replay runs
them again; the profiler's device trace records them by name, on the
device's clock, so the device work of a span instance is what ran between
its begin marker's start and its end marker's end (`device_spans`,
`span_times`). On the CPU nothing is launched. The markers are not counted in
`cuda_build.LAUNCHES`.

`begin_in_backward` opens a span where autograd reaches a set of tensors
(an identity whose backward launches the begin marker); the caller closes
it with `mark(name, True, device)` once the backward has returned.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import functools
import re
from typing import Dict, List, Sequence, Tuple

import torch
from torch.profiler import record_function

# a marker's symbol: ga_span__<span, "::" written "_">__<b | e>
MARKER = re.compile(r"ga_span__(\w+)__([be])")


def kernel_name(name: str) -> str:
    """A span's name as its markers spell it: train::decode -> train_decode."""
    return name.replace("::", "_")


@functools.lru_cache(maxsize=None)
def _markers() -> tuple:
    """The marker library's launch function and each span's index in it."""
    from gaussianavatar_torch.utils.cuda_build import MARKERS, load_library

    lib = load_library(MARKERS)
    lib.ga_span_count.argtypes, lib.ga_span_count.restype = [], ctypes.c_int
    lib.ga_span_name.argtypes, lib.ga_span_name.restype = [ctypes.c_int], ctypes.c_char_p
    fn = lib.ga_span_mark
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    index = {lib.ga_span_name(i).decode(): i for i in range(lib.ga_span_count())}
    return fn, index


def mark(name: str, end: bool, device: torch.device):
    """Launches span `name`'s begin (or, with `end`, end) marker on the
    current stream of a CUDA `device`; on any other device, nothing."""
    if device.type != "cuda":
        return
    fn, index = _markers()
    key = kernel_name(name)
    if key not in index:
        raise KeyError(f"span {name!r} has no markers in csrc/span_marks.cu")
    rc = fn(index[key], int(end), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"span marker launch failed: CUDA error {rc}")


@contextlib.contextmanager
def span(name: str, device: torch.device):
    """The host range `name`, and on a CUDA `device` its device markers."""
    with record_function(name):
        mark(name, False, device)
        yield
        mark(name, True, device)


class _BeginInBackward(torch.autograd.Function):
    """The identity, whose backward launches a span's begin marker once the
    gradients of all its outputs have reached it."""

    @staticmethod
    def forward(ctx, name, device, *xs):
        ctx.name, ctx.device = name, device
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        mark(ctx.name, False, ctx.device)
        return (None, None) + grads


def begin_in_backward(name: str, device: torch.device, *xs: torch.Tensor) -> tuple:
    """`xs` through an identity whose backward opens span `name` on the
    device (its begin marker): the backward of what computed `xs` follows
    it. The values and gradients are those of `xs`."""
    return _BeginInBackward.apply(name, device, *xs)


# ---------------------------------------------------------------- reading

def trace_ops(prof) -> List[Tuple[str, float, float]]:
    """The device operations (kernels, copies, fills) of a finished
    torch.profiler run -> [(name, start us, duration us)], by start. The
    profiler's copies of the host ranges on the device's timeline are left
    out."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((e.name, float(e.time_range.start), float(e.time_range.elapsed_us()))
                   for e in prof.events()
                   if e.device_type == cuda and not getattr(e, "is_user_annotation", False)),
                  key=lambda o: o[1])


def device_spans(ops: Sequence[Tuple[str, float, float]]) -> Dict[str, List[Tuple[float, float]]]:
    """Each span's instances on the device, {span: [(start us, end us)]} in
    order (the span named as its markers spell it, `train_decode`), from
    the markers among `ops`: a begin marker's start to the end marker's end
    that closes it (per name, as a stack, so nested and replayed instances
    pair). The profiler can lose the first kernels of its trace (those that
    start right after the profiler's own start): an end marker that comes
    before any begin marker of its span opens at the trace's first
    operation. Any other marker left unpaired raises."""
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
            raise ValueError(f"span {key}: an end marker at {t} us with no begin")
    left = [k for k, v in open_.items() if v]
    if left:
        raise ValueError(f"spans with a begin marker and no end: {left}")
    for v in out.values():
        v.sort()
    return out


class Busy:
    """The union of the intervals of the operations among `ops` (markers
    left out unless `markers`), and how much of an interval it covers."""

    def __init__(self, ops: Sequence[Tuple[str, float, float]], markers: bool = False):
        merged: List[List[float]] = []
        for name, t, d in sorted(ops, key=lambda o: o[1]):
            if not markers and MARKER.fullmatch(name):
                continue
            if merged and t <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t + d)
            else:
                merged.append([t, t + d])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.cum = [0.0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def within(self, a: float, b: float) -> float:
        """Microseconds of [a, b] in which an operation ran."""
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if j <= i:
            return 0.0
        total = self.cum[j] - self.cum[i]
        total -= max(0.0, a - self.starts[i])
        total -= max(0.0, self.ends[j - 1] - b)
        return total


def span_times(ops, since: float = float("-inf"),
               until: float = float("inf")) -> Dict[str, Tuple[int, float, float]]:
    """{span: (instances, busy us, idle us)} over the instances that lie in
    [since, until]: busy, the time in which an operation other than a
    marker ran; idle, the time in which no operation ran."""
    work, every = Busy(ops), Busy(ops, markers=True)
    out = {}
    for k, v in device_spans(ops).items():
        v = [(a, b) for a, b in v if since <= a and b <= until]
        if v:
            out[k] = (len(v), sum(work.within(a, b) for a, b in v),
                      sum(b - a - every.within(a, b) for a, b in v))
    return out
