"""Export a stage-1 avatar's optimized per-frame poses for stage 2
(counterpart of the JAX package's scripts/export_stage_1.py):

    python -m gaussianavatar_torch.export_stage_1 -m <stage-1 out> -s <data> [--epoch N]

Reads `net/iteration_N/net_torch.pt` (the newest save unless `--epoch` is
given) and writes `<data>/train/smpl_parms_pred.pth`: `beta` from the
split's `smpl_parms.pth`, `body_pose` and `trans` from the pose and
translation embeddings. The test split gets its own original parameters
under the same name. Both files are `torch.save`d dicts of tensors, which
the JAX package's `load_smpl_parms` reads too. Runs on the card unless
`--device cpu` is given (the checkpoint is mapped there and copied back).
"""

import os
import sys
from argparse import ArgumentParser
from os.path import join

PRED_NAME = "smpl_parms_pred.pth"


def main(argv=None):
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model_path", "-m", required=True, help="stage-1 output dir")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    import numpy as np
    import torch

    from gaussianavatar_torch.data.dataset import load_smpl_parms
    from gaussianavatar_torch.engine import checkpoint as ckpt
    from gaussianavatar_torch.engine.inference import require_device

    device = require_device(args.device)
    epoch = args.epoch if args.epoch is not None else ckpt.latest_epoch(args.model_path)
    if epoch is None:
        raise FileNotFoundError(f"no {ckpt.CKPT_NAME} under {args.model_path}/net/iteration_*")
    sd = torch.load(join(ckpt.ckpt_dir(args.model_path, epoch), ckpt.CKPT_NAME),
                    map_location=device, weights_only=True)
    pose, transl = (sd[k].detach().cpu() for k in ("pose_embedding", "transl_embedding"))

    def save(parms, path):
        torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in parms.items()}, path)

    train_dir = join(args.source_path, "train")
    orig = load_smpl_parms(join(train_dir, "smpl_parms.pth"))
    save({"beta": orig["beta"], "body_pose": pose.numpy(), "trans": transl.numpy()},
         join(train_dir, PRED_NAME))
    # the test split keeps its original (untouched) poses under the pred name
    test_dir = join(args.source_path, "test")
    if os.path.isdir(test_dir):
        save(load_smpl_parms(join(test_dir, "smpl_parms.pth")), join(test_dir, PRED_NAME))
    print(f"exported epoch {epoch} poses: {tuple(pose.shape)} -> {PRED_NAME}")


if __name__ == "__main__":
    main()
