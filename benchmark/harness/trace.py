"""The device trace of a traced sub-window, read from torch.profiler's
Chrome trace: the device operations (kernels, copies, fills) with their
times, the union of their intervals (busy time), the idle gaps inside the
window, and which of the benchmark's host spans (`bench::*`
record_function ranges) each gap fell in.

The profiler records CPU and CUDA activity; the window is the
`bench::traced` range the caller opens around the traced work, which ends
in a synchronize. The trace file goes to the temporary directory and is
deleted once read.
"""

from __future__ import annotations

import json
import os
import tempfile
from types import SimpleNamespace
from typing import Callable

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench::traced"


def record(fn: Callable[[], None]) -> SimpleNamespace:
    """Run fn() under the profiler inside a `bench::traced` range and a
    synchronize -> the parsed trace (`parse`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def parse(events: list) -> SimpleNamespace:
    """Chrome trace events -> namespace(window_s, busy_s, ops [(name,
    start_us, dur_us)], gaps [(host span, dur_s)], spans [(name, start_us,
    end_us)])."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW} range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op")
                    and str(e.get("name", "")).startswith("bench::") and e["name"] != WINDOW),
                   key=lambda s: s[1])
    busy, gaps = 0.0, []
    cur = w0
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, w0), min(s + d, w1)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            busy += e - s
        else:
            busy += e - cur
        cur = e
    if cur < w1:
        gaps.append((cur, w1))

    def host_at(t):
        inner = [sp for sp in spans if sp[1] <= t < sp[2]]
        return min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "bench::other"

    by_span = {}
    for a, b in gaps:
        k = host_at(a)
        by_span[k] = by_span.get(k, 0.0) + (b - a) / 1e6
    return SimpleNamespace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, ops=ops,
                           gaps=sorted(by_span.items(), key=lambda kv: -kv[1]), spans=spans)


def op_times(trace: SimpleNamespace) -> list:
    """[(device op name, summed seconds)], largest first."""
    tot = {}
    for name, _, d in trace.ops:
        tot[name] = tot.get(name, 0.0) + d / 1e6
    return sorted(tot.items(), key=lambda kv: -kv[1])


def kernel_time(trace: SimpleNamespace, symbol: str) -> tuple:
    """(summed seconds, launches) of the device ops whose name holds `symbol`."""
    hits = [d for name, _, d in trace.ops if symbol in name]
    return sum(hits) / 1e6, len(hits)
