"""hbwd_roofline: the blend's backward kernel (H-bwd, symbol
`blend_bwd_kernel`) against its roofline in training: the least time one
launch could take on its inputs, over its mean device time per launch in
the traced window.

The least time is the larger of two: the bytes (each binned gaussian's
attributes read once and its gradient written once, 9 floats each: mean
2, conic 3, colour 3, opacity 1; per pixel T, n_contrib, the colour and T
cotangents read, 6 words) over 3.35 TB/s; and the f32 operations, 74 per
contributing (gaussian, pixel) pair, over 67 TFLOP/s. Per contributing
pair the gradient needs: dx, dy (2), power (9), the two tests (2), exp,
opacity x exp, the clamp and its test (4), 1 - alpha, T / (1 - alpha),
the weight (3), dalpha (13), the suffix colours (9), dpow (2), the nine
integrands (21) and their sums over the tile (9). Pairs that do not
contribute are charged nothing. The counts come from the plain
reference's walk (harness/cells._train_work) of the last traced dispatch's
batches, at the program's weights and need caps after the traced window,
one launch per step."""

from benchmark.harness.flops import PEAK_FP32_FLOPS, PEAK_HBM_BYTES
from benchmark.harness.trace import kernel_time

SYMBOL = "blend_bwd_kernel"
OPS_PER_PAIR = 74
BYTES_PER_GAUSSIAN = 2 * 9 * 4
BYTES_PER_PIXEL = 6 * 4


def bound_s(w):
    b = w["gaussians"] * BYTES_PER_GAUSSIAN + w["pixels"] * BYTES_PER_PIXEL
    return max(b / PEAK_HBM_BYTES, w["contributing"] * OPS_PER_PAIR / PEAK_FP32_FLOPS)


def read(run):
    if run.kind != "train" or run.trace is None or run.work is None:
        return None
    t, n = kernel_time(run.trace, SYMBOL)
    if n == 0 or t <= 0:
        return None
    work = run.work()
    bound = sum(bound_s(w) for w in work) / len(work)
    return 100.0 * bound / (t / n)
