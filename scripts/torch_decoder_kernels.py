"""The fused decoder's kernels alone on the card: builds every kernel
(`chip_smoke.phase_setup`, with ptxas's register and spill lines), then holds
H-dstat, H-dfwd and H-dbwd against their plain versions and times each
beside its bound, plain version and library call at every stage shape of
`chip_smoke.py` phase 11 (a) (445,568 rows), printing that phase's lines.

    python3 scripts/torch_decoder_kernels.py

Needs a CUDA card; imports no JAX.
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_decoder_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    card = chip_smoke.phase_setup()
    t0 = time.perf_counter()
    chip_smoke._decoder_random_holds("cuda", card)
    print(f"held and timed in {time.perf_counter() - t0:.1f} s, on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
