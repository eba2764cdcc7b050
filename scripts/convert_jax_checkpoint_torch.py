"""Convert a JAX checkpoint of an avatar (stage 1 or 2) into the PyTorch port's.

Reads `<model>/net/iteration_N/net.ckpt` through gaussianavatar_tpu and
writes `net_torch.pt` (the port's AvatarNet state_dict) beside it, through
gaussianavatar_torch.bridge. Runs on the CPU:

    python scripts/convert_jax_checkpoint_torch.py -m <model_path> [--epoch N]
"""

import os
import sys
from argparse import ArgumentParser
from os.path import join

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--epoch", type=int, default=None)
    args = parser.parse_args(argv)

    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")

    from gaussianavatar_torch.bridge import state_dict_from_jax
    from gaussianavatar_torch.engine.checkpoint import save_state_dict
    from gaussianavatar_tpu.config import Config
    from gaussianavatar_tpu.engine.inference import load_trained

    cfg = Config.load(join(args.model_path, "cfg_args.json"))
    cfg.model.model_path = args.model_path
    inf = load_trained(cfg, args.epoch)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    sd = state_dict_from_jax(to_np(inf.state.params), to_np(inf.state.batch_stats))
    path = save_state_dict(args.model_path, inf.epoch, sd)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
