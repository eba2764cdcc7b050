"""Visual QA of a subject's SMPL fit (the port's counterpart of
scripts/render_pred_smpl.py): the body of each frame, posed by its
parameters, splatted as gray 1 cm gaussians and blended over the photo
where a white render of the same gaussians covers it (`--alpha`).

    python -m gaussianavatar_torch.render_pred_smpl --source_path <data> \
        [--synthetic | --smpl_model_path ...] [--use_pred] [--split train] \
        [--out <dir>] [--n_frames 8] [--alpha 0.6] [--device cpu]

The cameras and photos are the training split's (read with no mask); the
poses are `<split>/smpl_parms.pth`, or `smpl_parms_pred.pth` with
`--use_pred`. Both renders of a frame are one call of
`ops/rasterize.rasterize_views` with two views (the body, then the mask),
so each frame launches H-fwd once on the card. Writes
`<out>/NNNNN.png` (default `<source_path>/qa_overlay`). Runs on the card
unless `--device cpu` is given.
"""

import os
import sys
from argparse import ArgumentParser
from os.path import join


def main(argv=None, body_kwargs=None):
    """`body_kwargs`: keywords of `utils/synthetic.synthetic_body` for the
    `--synthetic` body (its defaults otherwise)."""
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source_path", required=True)
    parser.add_argument("--split", default="train")
    parser.add_argument("--smpl_model_path", default="")
    parser.add_argument("--smpl_type", default="smpl")
    parser.add_argument("--smpl_gender", default="neutral")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--use_pred", action="store_true")
    parser.add_argument("--out", default="")
    parser.add_argument("--n_frames", type=int, default=8)
    parser.add_argument("--alpha", type=float, default=0.6)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    import numpy as np
    import torch
    from PIL import Image

    from gaussianavatar_torch.config import ModelParams
    from gaussianavatar_torch.data.dataset import MonoDatasetTrain, load_smpl_parms
    from gaussianavatar_torch.engine.inference import require_device
    from gaussianavatar_torch.models import body as body_mod
    from gaussianavatar_torch.models.body import load_body_model
    from gaussianavatar_torch.ops.rasterize import RasterizeConfig, rasterize_views
    from gaussianavatar_torch.utils.synthetic import synthetic_body

    device = require_device(args.device)
    if args.synthetic:
        model, _ = synthetic_body(**(body_kwargs or {}))
    else:
        model = load_body_model(args.smpl_model_path, args.smpl_type, args.smpl_gender)
    model = model.to(device)

    mp = ModelParams(source_path=args.source_path,
                     dataset_type="synthetic" if args.synthetic else "peeplesnapshot",
                     smpl_type=args.smpl_type, no_mask=1)
    ds = MonoDatasetTrain(mp)
    name = "smpl_parms_pred.pth" if args.use_pred else "smpl_parms.pth"
    parms = load_smpl_parms(join(args.source_path, args.split, name))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    betas = t(np.asarray(parms["beta"]).reshape(1, -1))
    poses, trans = t(parms["body_pose"]), t(parms["trans"])

    out_dir = args.out or join(args.source_path, "qa_overlay")
    os.makedirs(out_dir, exist_ok=True)

    V = model.v_template.shape[0]
    # view 0 the gray body, view 1 the white mask, over a black background
    colors = torch.stack([torch.full((V, 3), 0.8), torch.ones((V, 3))]).to(device)
    scales = torch.full((2, V, 3), 0.01, device=device)
    quats = torch.zeros((V, 4), device=device)
    quats[:, 0] = 1.0
    opac = torch.ones((V,), device=device)
    bg = torch.zeros(3, device=device)
    cfg = RasterizeConfig()

    for i in range(min(args.n_frames, len(ds))):
        item = ds[i]
        H, W = int(item["height"]), int(item["width"])
        two = lambda k: t(item[k])[None].expand(2, *np.shape(item[k]))
        with torch.no_grad():
            out = body_mod.forward(model, betas, poses[i:i + 1, :3], poses[i:i + 1, 3:],
                                   transl=trans[i:i + 1])
            imgs, _ = rasterize_views(out.vertices.expand(2, -1, -1), colors, scales, quats,
                                      opac, two("world_view_transform"),
                                      two("full_proj_transform"), two("tan_fovx"),
                                      two("tan_fovy"), H, W, bg, config=cfg)
        imgs = imgs.cpu().numpy()
        body = imgs[0]
        m = np.clip(imgs[1].max(0, keepdims=True), 0, 1) * args.alpha
        photo = ds.frame_u8(i).astype(np.float32) / 255.0
        overlay = photo * (1 - m) + body * m
        png = (np.clip(overlay, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
        Image.fromarray(png).save(join(out_dir, f"{i:05d}.png"))
        print(f"frame {i}")
    print("done ->", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
