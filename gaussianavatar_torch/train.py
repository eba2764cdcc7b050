"""Training CLI of the port, stage 1, with the flags of the JAX package's
train.py (the port's `build_parser`, so `cfg_args.json` is the same):

    python -m gaussianavatar_torch.train -s <data_path> -m <out_path> --train_stage 1
    python -m gaussianavatar_torch.train ... --device cpu --max_steps 30
    python -m gaussianavatar_torch.train ... --checkpoint_epochs 100   # resume

Runs on the card unless `--device cpu` is given. `--checkpoint_epochs E`
resumes from `<out_path>/net/iteration_E` at epoch E + 1 (network,
optimizer state and iteration). `--start_checkpoint` is parsed and unused,
as in the JAX train.py. Stage 2, `--dp` and `--profile_dir` are not ported
yet and raise. LPIPS is not ported yet either: training runs as with
`--no_lpips`, and metrics.jsonl says so.
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
                        help="train without the LPIPS term (the port has none yet)")
    parser.add_argument("--profile_dir", type=str, default=None)
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    cfg = extract_config(args)
    not_ported = [flag for flag, asked in (
        ("--train_stage 2", cfg.model.train_stage != 1),
        ("--dp", args.dp != 1),
        ("--profile_dir", args.profile_dir is not None),
    ) if asked]
    if not_ported:
        raise NotImplementedError(f"not ported yet to gaussianavatar_torch: {', '.join(not_ported)}"
                                  " (later slices of the port; the JAX train.py has them)")

    import torch

    from gaussianavatar_torch.engine.loop import train

    saving_epochs = sorted(set(args.save_epochs + [cfg.opt.epochs]))
    # the JAX CLI seeds its host RNGs with 0; here the network's initial
    # weights draw from torch's default generator
    torch.manual_seed(0)
    torch.autograd.set_detect_anomaly(args.detect_anomaly)
    lpips_note = "disabled (--no_lpips)" if args.no_lpips else None
    with contextlib.ExitStack() as stack:
        if args.quiet:
            stack.enter_context(contextlib.redirect_stdout(stack.enter_context(
                open(os.devnull, "w"))))
        print(ignored_raster_note())
        print("Optimizing " + cfg.model.model_path)
        train(cfg, saving_epochs, device=args.device, max_steps=args.max_steps,
              lpips_note=lpips_note, checkpoint_epochs=args.checkpoint_epochs)
        print("\nTraining complete.")


if __name__ == "__main__":
    main()
