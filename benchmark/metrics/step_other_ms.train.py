"""step_other_ms.train: the device's busy time per traced training step in
the program's span `train::step` less what decode_ms.train,
raster_ms.train and optimizer_ms.train read inside it: the posing (LBS,
skinning, the attributes), the loss and the rest of the backward (the
loss's, the posing's, the projection's and the binning's gathers'), read
from the marker kernels in the device trace (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    step = spans.per_step(run, ("train::step",))
    parts = [spans.per_step(run, names)
             for names in (spans.DECODE_TRAIN, spans.RASTER_TRAIN, spans.OPTIMIZER)]
    if step is None or None in parts:
        return None
    return step - sum(parts)
