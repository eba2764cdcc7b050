"""Evaluation CLI of the port (counterpart of the JAX package's eval.py):
render the test split with a trained avatar (stage 1, or stage 2 from each
frame's input posmap), 4 frames per render call, and report PSNR, SSIM
and, with LPIPS weights, LPIPS per frame and their means.

    python -m gaussianavatar_torch.eval -m <out_path> [--epoch N] [--device cpu]

Reads `cfg_args.json` and `net/iteration_N/net_torch.pt` from the model
path (the newest epoch unless `--epoch` is given) and writes
`test_free/renders/NNNN.png`, `test_free/gt/NNNN.png` and
`test_free/results.txt` with the JAX eval's lines: `psnr:`, `ssim:`,
`lpips:` (the mean, or the JAX package's status line when no weights are
found under `<project_path>/assets/lpips/`, see ops/lpips.py) and
`raster_overflow:`, the (gaussian, tile) pairs the footprint cap M dropped
across the split (the port's blend has no capacity cascade, so nothing else
is dropped). Images are clipped to [0, 1] before the metrics; LPIPS takes
the render and the GT mapped to [-1, 1], one frame at a time, on the
render's device. Runs on the card unless `--device cpu` is given.
"""

import os
import sys
import time
from argparse import ArgumentParser
from os.path import join

import numpy as np

# frames per render call; the last call takes what is left (no padding)
EVAL_B = 4


def main(argv=None):
    """-> {"psnr", "ssim", "lpips", "raster_overflow", "frames", "render_s",
    "frame_psnr", "frame_ssim", "frame_lpips"}: the values written to
    results.txt (lpips None without weights), the frame count, the seconds
    spent in the render calls (host clock, each call's images copied to the
    host), and the per-frame metrics (frame_lpips empty without weights)."""
    from gaussianavatar_torch.config import Config, build_parser, extract_config, ignored_flags_note

    parser = ArgumentParser(description="Testing script parameters")
    build_parser(parser)
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    saved = None
    cfg_path = join(args.model_path or "", "cfg_args.json")
    if args.model_path and os.path.exists(cfg_path):
        saved = Config.load(cfg_path)
    cfg = extract_config(args, saved)
    print(ignored_flags_note())

    import torch
    from PIL import Image

    from gaussianavatar_torch.data.dataset import MonoDatasetTest
    from gaussianavatar_torch.engine.inference import (
        batch_from_item, load_fixed_inp, load_trained, make_renderer,
    )
    from gaussianavatar_torch.ops.lpips import lpips_status, try_load_lpips
    from gaussianavatar_torch.ops.ssim import psnr, ssim

    inf = load_trained(cfg, args.epoch, device=args.device)
    fix_inp = load_fixed_inp(cfg.model)
    print(f"evaluating epoch {inf.epoch}")
    test_ds = MonoDatasetTest(cfg.model)
    H, W = test_ds.image_hw()
    render = make_renderer(inf, H, W, with_overflow=True)
    lpips_fn = try_load_lpips(cfg.model.project_path, device=args.device)

    out_dir = join(cfg.model.model_path, "test_free")
    os.makedirs(join(out_dir, "renders"), exist_ok=True)
    os.makedirs(join(out_dir, "gt"), exist_ok=True)

    psnrs, ssims, lpipss = [], [], []
    total_overflow = 0
    render_s = 0.0
    n = len(test_ds)
    for start in range(0, n, EVAL_B):
        idxs = range(start, min(start + EVAL_B, n))
        items = [test_ds[i] for i in idxs]
        singles = [batch_from_item(it, fix_inp) for it in items]
        batch = {k: np.concatenate([s[k] for s in singles]) for k in singles[0]}
        t0 = time.perf_counter()
        imgs, overflow = render(batch)
        imgs = imgs.clamp(0.0, 1.0)
        host = imgs.cpu()  # the copy waits for the device
        render_s += time.perf_counter() - t0
        total_overflow += int(overflow)
        gt = np.stack([it["original_image"] for it in items])
        gt_dev = torch.as_tensor(gt, device=imgs.device)
        frame_psnr = psnr(imgs, gt_dev)[:, 0].tolist()
        frame_ssim = ssim(imgs, gt_dev, size_average=False).tolist()
        for j, i in enumerate(idxs):
            psnrs.append(frame_psnr[j])
            ssims.append(frame_ssim[j])
            if lpips_fn is not None:
                with torch.no_grad():
                    lpipss.append(float(lpips_fn(imgs[j:j + 1] * 2 - 1,
                                                 gt_dev[j:j + 1] * 2 - 1)))
            for name, arr in (("renders", host[j].numpy()), ("gt", gt[j])):
                png = (arr.transpose(1, 2, 0) * 255).astype(np.uint8)
                Image.fromarray(png).save(join(out_dir, name, f"{i:04d}.png"))
            print(f"frame {i}: psnr {psnrs[-1]:.2f} ssim {ssims[-1]:.4f}")

    result = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
              "lpips": float(np.mean(lpipss)) if lpipss else None,
              "raster_overflow": total_overflow, "frames": n, "render_s": render_s,
              "frame_psnr": psnrs, "frame_ssim": ssims, "frame_lpips": lpipss}
    lines = [
        f"psnr: {result['psnr']:.6f}",
        f"ssim: {result['ssim']:.6f}",
        # the skipped metric stays visible instead of silently missing
        f"lpips: {result['lpips']:.6f}" if lpipss else
        f"lpips: {lpips_status(cfg.model.project_path)}",
        # pairs the footprint cap dropped (0 = every pair of the split blended)
        f"raster_overflow: {total_overflow}",
    ]
    report = "\n".join(lines)
    with open(join(out_dir, "results.txt"), "w") as f:
        f.write(report + "\n")
    print(report)
    return result


if __name__ == "__main__":
    main()
