"""mfu.render: model FLOPs of the calls completed in the measured window
(a call decodes each of its frames, forward only; see harness/flops.py),
over the window's seconds, as a share of the H100's dense bf16 peak. A
configuration that renders from a canonical cache decodes nothing in the
window: no reading."""

from benchmark.harness.flops import PEAK_BF16_FLOPS


def read(run):
    if run.kind != "render" or not run.flops.get("call"):
        return None
    rate = run.flops["call"] * run.window["calls"] / run.window["seconds"]
    return 100.0 * rate / PEAK_BF16_FLOPS
