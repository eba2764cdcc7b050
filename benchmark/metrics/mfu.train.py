"""mfu.train: model FLOPs of the steps completed in the measured window
(harness/flops.py: the geometry convolutions, the stage-2 pose encoder and
the ShapeDecoder on the valid rows, x 3 for a training step; the blend is
left out), over the window's seconds, as a share of the H100's dense bf16
peak (989 TFLOP/s)."""

from benchmark.harness.flops import PEAK_BF16_FLOPS


def read(run):
    if run.kind != "train":
        return None
    rate = run.flops["step"] * run.window["steps"] / run.window["seconds"]
    return 100.0 * rate / PEAK_BF16_FLOPS
