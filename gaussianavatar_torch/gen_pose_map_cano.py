"""The canonical-pose preprocessing files of a subject (the port's
counterpart of scripts/gen_pose_map_cano.py), in one pass of the software
UV rasterizer:

    {split}/query_posemap_{R}_cano_{smpl}.npz   ('posmap{R}', (R, R, 3))
    {split}/{smpl}_cano_joint_mat.pth           ((J, 4, 4) canonical affines, torch.save)
    <project>/assets/lbs_map_{smpl}_{R}.npy     ((R*R, J) skinning weights)
    <project>/assets/uv_masks/uv_mask{R}_with_faceid_{smpl}.npy
    cano_smpl.obj                               (the canonical mesh)

    python -m gaussianavatar_torch.gen_pose_map_cano --source_path <data> \
        --smpl_model_path assets/smpl_files/smpl \
        --uv_template assets/template_mesh_smpl_uv.obj [--smpl_type smpl] [--device cpu]
    # or --synthetic for the procedural test body

The body forward runs on the card unless `--device cpu` is given; the UV
rasterizer runs on the host. Betas come from the first split's
`smpl_parms.pth`. An SMPL-X canonical pose is split into the body and its
extra parts before the forward.
"""

import os
import sys
from argparse import ArgumentParser
from os.path import join


def main(argv=None):
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source_path", required=True)
    parser.add_argument("--project_path", default=os.getcwd())
    parser.add_argument("--smpl_model_path", default="")
    parser.add_argument("--uv_template", default="")
    parser.add_argument("--smpl_type", default="smpl", choices=["smpl", "smplx"])
    parser.add_argument("--smpl_gender", default="neutral")
    parser.add_argument("--sizes", nargs="+", type=int, default=[512, 128])
    parser.add_argument("--splits", nargs="+", default=["train", "test"])
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    import numpy as np
    import torch

    from gaussianavatar_torch.config import smpl_canonical_pose, smplx_canonical_pose
    from gaussianavatar_torch.data.dataset import load_smpl_parms
    from gaussianavatar_torch.engine.inference import require_device
    from gaussianavatar_torch.models import body as body_mod
    from gaussianavatar_torch.models.body import load_body_model
    from gaussianavatar_torch.ops.uv_raster import bary_interpolate, rasterize_uv_atlas
    from gaussianavatar_torch.utils.obj_io import load_obj, save_obj
    from gaussianavatar_torch.utils.synthetic import synthetic_body

    device = require_device(args.device)
    if args.synthetic:
        model, uv = synthetic_body()
        uv_uvs, faces_v, faces_vt = uv.uvs, uv.faces_v, uv.faces_vt
        cano_pose = np.zeros(model.parents.shape[0] * 3, np.float32)
        cano_transl = None
    else:
        model = load_body_model(args.smpl_model_path, args.smpl_type, args.smpl_gender)
        mesh = load_obj(args.uv_template)
        uv_uvs, faces_v, faces_vt = mesh.uvs, mesh.faces_v, mesh.faces_vt
        cano_pose = (smplx_canonical_pose() if args.smpl_type == "smplx"
                     else smpl_canonical_pose())
        cano_transl = np.array([0.0, 0.3, 0.0], np.float32)

    smpl_data = load_smpl_parms(join(args.source_path, args.splits[0], "smpl_parms.pth"))
    betas = np.asarray(smpl_data["beta"]).reshape(1, -1).astype(np.float32)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    p = cano_pose[None]
    extra = {}
    if model.model_type == "smplx":
        extra = dict(jaw_pose=t(p[:, 66:69]), leye_pose=t(p[:, 69:72]),
                     reye_pose=t(p[:, 72:75]), left_hand_pose=t(p[:, 75:120]),
                     right_hand_pose=t(p[:, 120:165]))
        p = p[:, :66]
    with torch.no_grad():
        out = body_mod.forward(model.to(device), t(betas), t(p[:, :3]), t(p[:, 3:]),
                               transl=None if cano_transl is None else t(cano_transl[None]),
                               **extra)
    cano_verts = out.vertices[0].cpu().numpy()
    A = out.A[0].cpu()
    J = A.shape[0]
    lbs_weights = model.lbs_weights.cpu().numpy()

    save_obj(join(args.source_path, "cano_smpl.obj"), cano_verts, model.faces)

    os.makedirs(join(args.project_path, "assets", "uv_masks"), exist_ok=True)
    for R in args.sizes:
        raster = rasterize_uv_atlas(cano_verts, uv_uvs, faces_v, faces_vt, R)
        lbs_map = bary_interpolate(lbs_weights, faces_v, raster)
        np.save(join(args.project_path, "assets", f"lbs_map_{args.smpl_type}_{R}.npy"),
                lbs_map.reshape(R * R, J))
        np.save(join(args.project_path, "assets", "uv_masks",
                     f"uv_mask{R}_with_faceid_{args.smpl_type}.npy"),
                raster.face_id.reshape(-1))
        for split in args.splits:
            d = join(args.source_path, split)
            if not os.path.isdir(d):
                continue
            np.savez(join(d, f"query_posemap_{R}_cano_{args.smpl_type}.npz"),
                     **{f"posmap{R}": raster.position_map})
            torch.save(A.clone(), join(d, f"{args.smpl_type}_cano_joint_mat.pth"))
        print(f"size {R}: {int((raster.face_id >= 0).sum())} valid uv pixels")
    print("done")


if __name__ == "__main__":
    main()
