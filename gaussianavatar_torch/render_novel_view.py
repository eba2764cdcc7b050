"""Novel-view (bullet-time) CLI of the port (counterpart of the JAX
package's render_novel_view.py): orbit the test split's camera around a
fixed pose of a trained avatar, 4 frames per render call (a stage-2
avatar decodes the pose's input posmap, or its fixed posmap).

    python -m gaussianavatar_torch.render_novel_view -m <out_path> [--epoch N] \
        [--bullet_pose_list 112 217 755] [--frames 60] [--device cpu]

The orbit's center is the rest-pose pelvis of the body model plus the
pose's translation. Bullet poses past the end of the test split are
skipped; if none is left, pose 0 is rendered. Writes
`novel_view/pose_P/NNNNN.png`. Runs on the card unless `--device cpu` is
given.
"""

import os
import sys
from argparse import ArgumentParser
from os.path import join

import numpy as np

REN_B = 4


def main(argv=None):
    from gaussianavatar_torch.config import Config, build_parser, extract_config, ignored_raster_note

    parser = ArgumentParser(description="Novel view rendering parameters")
    build_parser(parser)
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--frames", type=int, default=60, help="frames per orbit")
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    saved = None
    cfg_path = join(args.model_path or "", "cfg_args.json")
    if args.model_path and os.path.exists(cfg_path):
        saved = Config.load(cfg_path)
    cfg = extract_config(args, saved)
    print(ignored_raster_note())

    import torch
    from PIL import Image

    from gaussianavatar_torch.data.dataset import MonoDatasetNovelView
    from gaussianavatar_torch.engine.inference import (
        batch_from_item, load_fixed_inp, load_trained, make_renderer,
    )
    from gaussianavatar_torch.models import body as body_mod

    inf = load_trained(cfg, args.epoch, device=args.device)
    fix_inp = load_fixed_inp(cfg.model)
    ds = MonoDatasetNovelView(cfg.model)
    H, W = ds.image_hw()

    # orbit center: the rest-pose pelvis (joint 0), plus the frame's translation
    body, assets = inf.bundle.body_model, inf.bundle.assets
    zeros = lambda n: torch.zeros((1, n), device=assets.betas.device)
    with torch.no_grad():
        rest = body_mod.forward(body, assets.betas[None], zeros(3),
                                zeros(inf.bundle.frames.pose_data.shape[1] - 3))
    pelvis = rest.joints[0, 0].cpu().numpy()

    # the default bullet_pose_list (112/217/755) indexes People Snapshot
    # frames; on shorter sequences fall back to frame 0
    n_poses = len(ds.pose_data)
    pose_list = [p for p in cfg.model.bullet_pose_list if p < n_poses]
    for p in cfg.model.bullet_pose_list:
        if p >= n_poses:
            print(f"skipping bullet pose {p} (only {n_poses} frames)")
    if not pose_list:
        print("no bullet pose in range; falling back to pose 0")
        pose_list = [0]

    render = make_renderer(inf, H, W)
    for pose_idx in pose_list:
        ds.set_fixed_pose(pose_idx, args.frames, pelvis)
        out_dir = join(cfg.model.model_path, "novel_view", f"pose_{pose_idx}")
        os.makedirs(out_dir, exist_ok=True)
        print(f"orbiting pose {pose_idx}: {args.frames} frames at {W}x{H}")
        for start in range(0, args.frames, REN_B):
            idxs = range(start, min(start + REN_B, args.frames))
            singles = [batch_from_item(ds[i], fix_inp) for i in idxs]
            batch = {k: np.concatenate([s[k] for s in singles]) for k in singles[0]}
            imgs = render(batch).cpu().numpy()
            for j, i in enumerate(idxs):
                png = (np.clip(imgs[j], 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
                Image.fromarray(png).save(join(out_dir, f"{i:05d}.png"))
        if args.video:
            from gaussianavatar_torch.utils.video import save_video

            save_video(out_dir, join(out_dir, "orbit.mp4"), (W, H))
    print("done")


if __name__ == "__main__":
    main()
