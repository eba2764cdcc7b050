"""decode_ms.train: the device's busy time in the POP decoder, forward and
backward, per traced training step: the program's spans `train::decode`
(the embedding lookup, the pose encoder in stage 2, the decoder) and
`train::decode_bwd` (from where autograd reaches the decoder's outputs to
the end of the step's backward), read from their marker kernels in the
device trace (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    return spans.per_step(run, spans.DECODE_TRAIN)
