"""hfwd_roofline: the blend's forward kernel (H-fwd, symbol
`blend_fwd_kernel`) against its roofline in rendering: the least time a
call's launch (all of its frames) could take on its inputs, over its
device time, summed over the traced calls.

The least time is the larger of two: the bytes (each binned gaussian's
attributes read once, 9 floats: mean 2, conic 3, colour 3, opacity 1; each
pixel's colour and T written once, 4 floats) over 3.35 TB/s; and the f32
operations, 26 per contributing (gaussian, pixel) pair, over 67 TFLOP/s.
Per contributing pair the blend needs: dx, dy (2), power (9), the test
(1), exp, opacity x exp and the clamp (3), the test (1), 1 - alpha and
T (1 - alpha) (2), the test (1), the weight (1), three colour
multiply-adds (6). Pairs that do not contribute are charged nothing. The
counts come from the plain reference's walk of the traced calls' frames
(harness/cells._Reference)."""

from benchmark.harness.flops import PEAK_FP32_FLOPS, PEAK_HBM_BYTES
from benchmark.harness.trace import kernel_time

SYMBOL = "blend_fwd_kernel"
OPS_PER_PAIR = 26
BYTES_PER_GAUSSIAN = 9 * 4
BYTES_PER_PIXEL = 4 * 4


def bound_s(w):
    b = w["gaussians"] * BYTES_PER_GAUSSIAN + w["pixels"] * BYTES_PER_PIXEL
    return max(b / PEAK_HBM_BYTES, w["contributing"] * OPS_PER_PAIR / PEAK_FP32_FLOPS)


def read(run):
    if run.kind != "render" or run.trace is None or run.work is None:
        return None
    t, n = kernel_time(run.trace, SYMBOL)
    if n == 0 or t <= 0:
        return None
    work = run.work()
    if len(work) != n:
        return None
    return 100.0 * sum(bound_s(w) for w in work) / t
