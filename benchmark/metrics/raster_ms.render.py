"""raster_ms.render: the device's busy time in the rasterizer per traced
render call: the program's spans `render::projection`, `render::binning`,
`render::blend` (H-fwd) and `render::untile`, read from their marker
kernels in the device trace (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    return spans.per_call(run, spans.RASTER_FWD)
