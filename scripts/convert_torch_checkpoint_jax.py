"""Convert a checkpoint of the PyTorch port (a stage-1 avatar) into the JAX
package's.

Reads `<model>/net/iteration_N/net_torch.pt` and, where training left it,
`train_torch.pt` (the optimizer's counts and moments and the iteration),
and writes `net.ckpt` beside them: the JAX TrainState, whose trees are built
by the JAX package (`init_state`, `build_optimizer(...).init`) and filled
through gaussianavatar_torch.bridge. The JAX eval.py, render_novel_pose.py
and `train.py --checkpoint_epochs N` read it. Without `train_torch.pt` the
optimizer state stays at its initial value and the iteration at 0. Runs on
the CPU:

    python scripts/convert_torch_checkpoint_jax.py -m <model_path> [--epoch N]
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
    import jax.numpy as jnp
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")

    from gaussianavatar_torch.bridge import jax_trees_from_port
    from gaussianavatar_torch.engine import checkpoint as tckpt
    from gaussianavatar_tpu.config import Config
    from gaussianavatar_tpu.engine import checkpoint as jckpt
    from gaussianavatar_tpu.engine.optim import build_optimizer
    from gaussianavatar_tpu.engine.setup import setup_avatar
    from gaussianavatar_tpu.engine.train_step import init_state

    cfg = Config.load(join(args.model_path, "cfg_args.json"))
    cfg.model.model_path = args.model_path
    epoch = args.epoch if args.epoch is not None else tckpt.latest_epoch(args.model_path)
    if epoch is None:
        raise FileNotFoundError(f"no {tckpt.CKPT_NAME} under {args.model_path}/net/iteration_*")

    class _TX0:
        def init(self, p):
            return None

    # the JAX TrainState's trees, as the JAX package's own load_trained builds them
    bundle = setup_avatar(cfg, train=False)
    steps_per_epoch = max(len(bundle.train_dataset) // cfg.model.batch_size, 1)
    state = init_state(bundle.net, bundle.assets, _TX0(), batch_size=1)
    tx = build_optimizer(state.params, cfg.opt, steps_per_epoch, cfg.model.train_stage)
    state = state.replace(opt_state=tx.init(state.params))
    keys = ("params", "batch_stats", "opt_state")
    template = {k: jax.tree.map(np.asarray, getattr(state, k)) for k in keys}

    d = tckpt.ckpt_dir(args.model_path, epoch)
    load = lambda name: torch.load(join(d, name), map_location="cpu", weights_only=True)
    net_sd = load(tckpt.CKPT_NAME)
    opt_sd, iteration = None, 0
    if os.path.exists(join(d, tckpt.TRAIN_NAME)):
        saved = load(tckpt.TRAIN_NAME)
        opt_sd, iteration = saved["optimizer"], saved["iteration"]
    else:
        print(f"no {tckpt.TRAIN_NAME} in {d}: the optimizer state stays initial, iteration 0")
    trees = jax_trees_from_port(net_sd, opt_sd, template)
    state = state.replace(**{k: jax.tree.map(jnp.asarray, trees[k]) for k in keys},
                          iteration=jnp.int32(iteration))
    path = jckpt.save_checkpoint(args.model_path, epoch, state)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
