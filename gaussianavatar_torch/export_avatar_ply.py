"""Export a trained avatar's posed gaussians as a standard 3DGS PLY (the
port's counterpart of scripts/export_avatar_ply.py), for any
gaussian-splatting viewer:

    python -m gaussianavatar_torch.export_avatar_ply -m <model_path> [--epoch N] \
        [--frame 0 | --pose_file <smpl_parms.pth> --pose_idx 0] [--out avatar.ply] \
        [--device cpu]

The gaussians are the ones the renderer draws for that pose
(`engine/inference.frame_gaussians`, at the inference iteration): the
training frame's pose embedding, or pose `--pose_idx` of an external
smpl_parms file. As in the JAX script, a stage-2 avatar decodes with no
pose feature map (the batch carries no input posmap). Writes
`<model_path>/avatar_frame{F}.ply` unless `--out` is given. Runs on the
card unless `--device cpu` is given.
"""

import sys
from argparse import ArgumentParser
from os.path import join


def main(argv=None):
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--frame", type=int, default=0, help="training frame index")
    parser.add_argument("--pose_file", default=None, help="external smpl_parms for the pose")
    parser.add_argument("--pose_idx", type=int, default=0)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    import numpy as np

    from gaussianavatar_torch.config import Config
    from gaussianavatar_torch.data.dataset import load_smpl_parms
    from gaussianavatar_torch.engine.export import export_gaussians_ply
    from gaussianavatar_torch.engine.inference import frame_gaussians, load_trained, require_device

    require_device(args.device)
    cfg = Config.load(join(args.model_path, "cfg_args.json"))
    cfg.model.model_path = args.model_path
    inf = load_trained(cfg, args.epoch, device=args.device)

    batch = {"pose_idx": np.asarray([args.frame], np.int32)}
    if args.pose_file:
        parms = load_smpl_parms(args.pose_file)
        sl = slice(args.pose_idx, args.pose_idx + 1)
        batch["pose_data"] = np.asarray(parms["body_pose"][sl], np.float32)
        batch["transl_data"] = np.asarray(parms["trans"][sl], np.float32)

    world, colors, scales3, rotations, opacity = frame_gaussians(inf.bundle, batch)
    nv = inf.bundle.assets.num_valid
    host = lambda t: t.cpu().numpy()
    out_path = args.out or join(args.model_path, f"avatar_frame{args.frame}.ply")
    export_gaussians_ply(out_path, host(world[0, :nv]), host(colors[0, :nv]),
                         host(scales3[0, :nv]), host(opacity[:nv]), host(rotations[:nv]))
    print(f"wrote {out_path} ({nv} gaussians, epoch {inf.epoch})")
    return out_path


if __name__ == "__main__":
    main()
