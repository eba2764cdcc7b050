"""raster_ms.train: the device's busy time in the rasterizer per traced
training step: the program's spans `render::projection`, `render::binning`,
`render::blend` (H-fwd), `render::untile`, and on the way back
`render::blend_bwd` (H-bwd) and `render::scatter_bwd`, read from their
marker kernels in the device trace (harness/spans.py). The backward of the
projection and of the binning's gathers runs outside them, in
step_other_ms.train."""

from benchmark.harness import spans


def read(run):
    return spans.per_step(run, spans.RASTER_TRAIN)
