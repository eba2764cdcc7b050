"""Per-frame posed position maps for stage 2 (counterpart of the JAX
package's scripts/gen_pose_map_frames.py): each frame's body, posed by the
port's SMPL / SMPL-X forward, rasterized in UV space
(`ops/uv_raster.rasterize_uv_atlas`) into
`<split>/inp_map/inp_posemap_{S}_{idx:08d}.npz` (key `posmap{S}`, (S, S, 3)
float32, zero off the atlas).

    python -m gaussianavatar_torch.gen_pose_map_frames --source_path <data> \
        [--synthetic | --smpl_model_path ... --uv_template ...] [--size 128]

Poses come from `smpl_parms_pred.pth` (export_stage_1) where the split has
it, else from `smpl_parms.pth`. The body forward runs on the card unless
`--device cpu` is given; the UV rasterizer runs on the host.
"""

import os
import sys
from argparse import ArgumentParser
from os.path import join


def main(argv=None):
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source_path", required=True)
    parser.add_argument("--smpl_model_path", default="")
    parser.add_argument("--uv_template", default="")
    parser.add_argument("--smpl_type", default="smpl", choices=["smpl", "smplx"])
    parser.add_argument("--smpl_gender", default="neutral")
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--splits", nargs="+", default=["train", "test"])
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    import numpy as np
    import torch

    from gaussianavatar_torch.data.dataset import load_smpl_parms
    from gaussianavatar_torch.engine.inference import require_device
    from gaussianavatar_torch.models import body as body_mod
    from gaussianavatar_torch.models.body import load_body_model
    from gaussianavatar_torch.ops.uv_raster import rasterize_uv_atlas
    from gaussianavatar_torch.utils.obj_io import load_obj
    from gaussianavatar_torch.utils.synthetic import synthetic_body

    device = require_device(args.device)
    if args.synthetic:
        model, uv = synthetic_body()
        uv_uvs, faces_v, faces_vt = uv.uvs, uv.faces_v, uv.faces_vt
    else:
        model = load_body_model(args.smpl_model_path, args.smpl_type, args.smpl_gender)
        mesh = load_obj(args.uv_template)
        uv_uvs, faces_v, faces_vt = mesh.uvs, mesh.faces_v, mesh.faces_vt
    model = model.to(device)

    S = args.size
    t = lambda a: torch.as_tensor(a, device=device)
    for split in args.splits:
        d = join(args.source_path, split)
        if not os.path.isdir(d):
            continue
        name = "smpl_parms_pred.pth"
        if not os.path.exists(join(d, name)) and not os.path.exists(join(d, name + ".npz")):
            name = "smpl_parms.pth"
        parms = load_smpl_parms(join(d, name))
        betas = np.asarray(parms["beta"], np.float32).reshape(1, -1)
        poses = np.asarray(parms["body_pose"], np.float32)
        trans = np.asarray(parms["trans"], np.float32)
        n = len(os.listdir(join(d, "images"))) if os.path.isdir(join(d, "images")) else len(poses)
        os.makedirs(join(d, "inp_map"), exist_ok=True)
        for i in range(min(n, len(poses))):
            p = poses[i:i + 1]
            extra = {}
            if args.smpl_type == "smplx":
                extra = dict(jaw_pose=t(p[:, 66:69]), leye_pose=t(p[:, 69:72]),
                             reye_pose=t(p[:, 72:75]), left_hand_pose=t(p[:, 75:120]),
                             right_hand_pose=t(p[:, 120:165]))
                p = p[:, :66]
            with torch.no_grad():
                out = body_mod.forward(model, t(betas), t(p[:, :3]), t(p[:, 3:]),
                                       transl=t(trans[i:i + 1]), **extra)
            raster = rasterize_uv_atlas(out.vertices[0].cpu().numpy(), uv_uvs, faces_v,
                                        faces_vt, S)
            np.savez(join(d, "inp_map", f"inp_posemap_{S}_{i:08d}.npz"),
                     **{f"posmap{S}": raster.position_map})
            if i % 50 == 0:
                print(f"{split} frame {i}/{n}")
    print("done")


if __name__ == "__main__":
    main()
