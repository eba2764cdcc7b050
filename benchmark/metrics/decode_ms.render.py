"""decode_ms.render: the device's busy time in the decode per traced render
call: the program's span `render::decode` (the pose encoder and the POP
decoder in eval mode, every frame of the call), read from its marker
kernels in the device trace (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    return spans.per_call(run, ("render::decode",))
