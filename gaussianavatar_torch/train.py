"""Training CLI of the port, stages 1 and 2, with the flags of the JAX
package's train.py (the port's `build_parser`, so `cfg_args.json` is the
same):

    python -m gaussianavatar_torch.train -s <data_path> -m <out_path> --train_stage 1
    python -m gaussianavatar_torch.train ... --device cpu --max_steps 30
    python -m gaussianavatar_torch.train ... --checkpoint_epochs 100   # resume
    python -m gaussianavatar_torch.train -s <data_path> -m <out2> --train_stage 2 \
        --stage1_out_path <out_path>/net/iteration_200 [--fixed_inp 1]

Runs on the card unless `--device cpu` is given. `--checkpoint_epochs E`
resumes from `<out_path>/net/iteration_E` at epoch E + 1 (network,
optimizer state and iteration). Stage 2 needs `smpl_parms_pred.pth` and the
per-frame input posmaps in the dataset (`python -m
gaussianavatar_torch.export_stage_1`, then `python -m
gaussianavatar_torch.gen_pose_map_frames`), or with `--fixed_inp 1` the
canonical posmap at the input resolution. `--start_checkpoint` is parsed
and unused, as in the JAX train.py. `--pos_encoding 1`, `--dp` and
`--profile_dir` are not ported yet and raise.

LPIPS: with weights under `<project_path>/assets/lpips/` (or the
repository's), `lpips_alex.npz` or the raw `alexnet*.pth` + `alex.pth` pair
(ops/lpips.try_load_lpips), the loss gains 0.2 * LPIPS after
`--lpips_start_iter` epochs (30); `--no_lpips` turns it off. metrics.jsonl
records which (the `lpips` event).
"""

import contextlib
import os
import sys
from argparse import ArgumentParser


def main(argv=None):
    from gaussianavatar_torch.config import build_parser, extract_config, ignored_raster_note

    parser = ArgumentParser(description="Training script parameters")
    build_parser(parser)
    # --debug_from is parsed for flag parity with the JAX CLI, which ignores it too
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--save_epochs", nargs="+", type=int, default=[100])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_epochs", nargs="+", type=int, default=[])
    # parsed for flag parity with the JAX CLI, which does not use it either
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop once the iteration reaches N")
    parser.add_argument("--no_lpips", action="store_true",
                        help="disable the LPIPS loss term even if weights are available")
    parser.add_argument("--profile_dir", type=str, default=None)
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    cfg = extract_config(args)
    not_ported = [flag for flag, asked in (
        ("--pos_encoding 1", bool(cfg.net.pos_encoding)),
        ("--dp", args.dp != 1),
        ("--profile_dir", args.profile_dir is not None),
    ) if asked]
    if not_ported:
        raise NotImplementedError(f"not ported yet to gaussianavatar_torch: {', '.join(not_ported)}"
                                  " (later slices of the port; the JAX train.py has them)")

    import torch

    from gaussianavatar_torch.engine.inference import require_device
    from gaussianavatar_torch.engine.loop import train
    from gaussianavatar_torch.ops.lpips import try_load_lpips

    saving_epochs = sorted(set(args.save_epochs + [cfg.opt.epochs]))
    # the JAX CLI seeds its host RNGs with 0; here the network's initial
    # weights draw from torch's default generator
    torch.manual_seed(0)
    torch.autograd.set_detect_anomaly(args.detect_anomaly)
    require_device(args.device)
    with contextlib.ExitStack() as stack:
        if args.quiet:
            stack.enter_context(contextlib.redirect_stdout(stack.enter_context(
                open(os.devnull, "w"))))
        print(ignored_raster_note())
        print("Optimizing " + cfg.model.model_path)
        lpips_fn, lpips_note = None, None
        if args.no_lpips:
            lpips_note = "disabled (--no_lpips)"
        else:
            lpips_fn = try_load_lpips(cfg.model.project_path, device=args.device)
            if lpips_fn is None:
                print("LPIPS weights not found; training without the LPIPS term")
        train(cfg, saving_epochs, device=args.device, max_steps=args.max_steps,
              lpips_note=lpips_note, checkpoint_epochs=args.checkpoint_epochs,
              lpips_fn=lpips_fn)
        print("\nTraining complete.")


if __name__ == "__main__":
    main()
