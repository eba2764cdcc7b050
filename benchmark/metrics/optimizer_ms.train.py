"""optimizer_ms.train: the device's busy time in the optimizer per traced
training step: the program's span `train::optimizer` (the pose gate on the
embeddings' gradients, the Adam groups and SparseAdam), read from its
marker kernels in the device trace (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    return spans.per_step(run, spans.OPTIMIZER)
