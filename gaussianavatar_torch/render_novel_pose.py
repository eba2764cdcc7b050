"""Novel-pose animation CLI of the port: drive a trained avatar with an
external pose sequence (assets/test_pose by default: a static camera,
1024x1024 frames), 4 frames per render call. A stage-2 avatar reads each
pose's input posmap from the folder's inp_map/ (gen_pose_map_frames writes
them), or takes its fixed posmap.

    python -m gaussianavatar_torch.render_novel_pose -m <out_path> --epoch 200

Reads `cfg_args.json` from the model path and `net/iteration_N/net_torch.pt`
(scripts/convert_jax_checkpoint_torch.py converts a JAX checkpoint). Runs on
the card unless `--device cpu` is given.
"""

import os
import sys
import time
from argparse import ArgumentParser
from os.path import join

import numpy as np

# animation rendering is a batch workload: 4 frames per render call
REN_B = 4


def main(argv=None):
    from gaussianavatar_torch.config import Config, build_parser, extract_config, ignored_flags_note

    parser = ArgumentParser(description="Novel pose rendering parameters")
    build_parser(parser)
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--image_size", type=int, default=1024)
    parser.add_argument("--video", action="store_true", help="also write an mp4")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    saved = None
    cfg_path = join(args.model_path or "", "cfg_args.json")
    if args.model_path and os.path.exists(cfg_path):
        saved = Config.load(cfg_path)
    cfg = extract_config(args, saved)
    print(ignored_flags_note())

    from PIL import Image
    import torch

    from gaussianavatar_torch.data.dataset import MonoDatasetNovelPose
    from gaussianavatar_torch.engine.inference import (
        batch_from_item, load_fixed_inp, load_trained, make_renderer,
    )

    inf = load_trained(cfg, args.epoch, device=args.device)
    fix_inp = load_fixed_inp(cfg.model)
    ds = MonoDatasetNovelPose(cfg.model, height=args.image_size, width=args.image_size)
    render = make_renderer(inf, args.image_size, args.image_size)

    out_dir = join(cfg.model.model_path, "novel_pose")
    os.makedirs(out_dir, exist_ok=True)
    print(f"rendering {len(ds)} novel poses at {args.image_size}^2 (epoch {inf.epoch})")

    n = len(ds)
    render_s = 0.0
    for start in range(0, n, REN_B):
        idxs = list(range(start, min(start + REN_B, n)))
        pad = [idxs[-1]] * (REN_B - len(idxs))
        singles = [batch_from_item(ds[i], fix_inp) for i in idxs + pad]
        batch = {k: np.concatenate([s[k] for s in singles]) for k in singles[0]}
        t0 = time.perf_counter()
        imgs = render(batch).cpu().numpy()  # the copy waits for the device
        render_s += time.perf_counter() - t0
        for j, i in enumerate(idxs):
            png = (np.clip(imgs[j], 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
            Image.fromarray(png).save(join(out_dir, f"{i:05d}.png"))
        if start % 48 == 0:
            print(f"frame {start}/{n}")
    steps = -(-n // REN_B)
    if steps > 1 and render_s > 0:
        where = torch.cuda.get_device_name(0) if inf.bundle.assets.query_points.is_cuda else "cpu"
        print(f"render rate: {n / render_s:.1f} FPS @{args.image_size}^2 on {where} "
              "(incl. the first call's kernel build)")

    if args.video:
        from gaussianavatar_torch.utils.video import save_video

        save_video(out_dir, join(out_dir, "novel_pose.mp4"), (args.image_size, args.image_size))
    print("done:", out_dir)


if __name__ == "__main__":
    main()
