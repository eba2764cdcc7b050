"""Convert LPIPS(alex) weights to the npz layout `ops/lpips.py` loads (the
port's counterpart of scripts/convert_lpips_weights.py):

    python -m gaussianavatar_torch.convert_lpips_weights \
        --alexnet_pth alexnet-owt-7be5be79.pth --lins_pth alex.pth \
        --out assets/lpips/lpips_alex.npz

The inputs are the torchvision AlexNet state dict and the lpips v0.1 linear
heads, copied onto the machine by the user; they are read with
`torch.load(weights_only=True)`. `ops/lpips.try_load_lpips` also takes that
pair dropped straight into `assets/lpips/`, so the conversion is optional.
The JAX script's other path, through the pip `lpips` package and its
downloads, is left out: it needs a package and a network this port does
not assume.

Layout: conv{0..4}_w (O, I, kh, kw), conv{0..4}_b (O,), lin{0..4} (C,) (the
non-negative 1x1 head weights, squeezed). Runs on the host only.
"""

import os
import sys
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="assets/lpips/lpips_alex.npz")
    parser.add_argument("--alexnet_pth", required=True,
                        help="torchvision AlexNet state dict")
    parser.add_argument("--lins_pth", required=True, help="lpips v0.1 alex.pth linear heads")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    import numpy as np

    from gaussianavatar_torch.ops.lpips import weights_from_pth

    out = weights_from_pth(args.alexnet_pth, args.lins_pth)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **out)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
