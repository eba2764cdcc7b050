"""Multi-subject training CLI of the port (counterpart of the JAX package's
root train_multi.py): S avatars trained side by side on one card, each
optionally data-parallel over `--dp` ranks.

    python -m gaussianavatar_torch.train_multi --sources dataA dataB dataC dataD \\
        -m <out_root> [--dp 2] [--train_stage 1] [--device cpu] ...

Every single-subject flag applies to every subject. Outputs land in
`<out_root>/<subject_name>/` with the single-subject layout (cfg_args.json,
net/iteration_N/, metrics.jsonl, log/), so `python -m
gaussianavatar_torch.eval -m <out_root>/<name>` and single-subject resume
take each subject as it is. `--checkpoint_epochs E` resumes every subject
from its epoch-E save; `--eval_after` evaluates every subject after
training. Subject names are the data directories' basenames, suffixed where
they collide.

`--dp N` spawns N ranks (parallel/mesh.py), each holding every subject and
stepping it on its shard of the subject's global batch (parallel/grid.py);
the JAX CLI asks for S x dp devices instead. Runs on the card unless
`--device cpu` is given (`--dp` then runs its ranks on the CPU over gloo).
"""

import sys
from argparse import ArgumentParser
from os.path import basename, join, normpath


def subject_names(sources):
    """Directory basenames, suffixed on collision."""
    names, seen = [], {}
    for s in sources:
        n = basename(normpath(s)) or "subject"
        if n in seen:
            seen[n] += 1
            n = f"{n}_{seen[n]}"
        else:
            seen[n] = 0
        names.append(n)
    return names


def main(argv=None, timeout_s=None):
    """`timeout_s` bounds a `--dp` run: its ranks are stopped and the call
    raises if they have not all finished by then."""
    from gaussianavatar_torch.config import build_parser, extract_config, ignored_raster_note

    parser = ArgumentParser(description="Multi-subject training parameters")
    build_parser(parser)
    parser.add_argument("--sources", nargs="+", required=True,
                        help="one data directory per subject")
    parser.add_argument("--dp", type=int, default=1,
                        help="per-subject data-parallel degree: each subject's batch is "
                             "sharded over this many ranks")
    parser.add_argument("--save_epochs", nargs="+", type=int, default=[100])
    parser.add_argument("--checkpoint_epochs", nargs="+", type=int, default=[])
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps (testing)")
    parser.add_argument("--eval_after", action="store_true",
                        help="evaluate every subject after training")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    out_root = args.model_path
    if not out_root:
        parser.error("-m/--model_path (output root) is required")

    from gaussianavatar_torch.engine.inference import require_device
    from gaussianavatar_torch.parallel import mesh

    require_device(args.device)
    names = subject_names(args.sources)
    cfgs = []
    for src, name in zip(args.sources, names):
        cfg = extract_config(args)
        cfg.model.source_path = src
        cfg.model.model_path = join(out_root, name)
        cfgs.append(cfg)
    mesh.check_batch(cfgs[0].model.batch_size, args.dp)

    saving_epochs = sorted(set(args.save_epochs + [cfgs[0].opt.epochs]))
    if not args.quiet:
        print(ignored_raster_note())
        print(f"Optimizing {len(cfgs)} subjects into {out_root} "
              f"({len(cfgs)} subjects x dp {args.dp}): {', '.join(names)}")
    run_args = (cfgs, saving_epochs, args.checkpoint_epochs, args.device, args.max_steps,
                args.quiet)
    if args.dp > 1:
        mesh.spawn_ranks(run_training, args.dp, args.device, run_args, timeout_s=timeout_s)
    else:
        run_training(*run_args)
    if not args.quiet:
        print("\nTraining complete.")

    if args.eval_after:
        from gaussianavatar_torch import eval as eval_cli

        for cfg, name in zip(cfgs, names):
            print(f"\nEvaluating subject {name}")
            eval_cli.main(["-m", cfg.model.model_path, "--device", args.device])


def run_training(cfgs, saving_epochs, checkpoint_epochs, device, max_steps, quiet):
    """The training run of `main`, in this process or in one rank of a
    data-parallel group (on the group's device)."""
    import contextlib
    import os

    import torch

    from gaussianavatar_torch.engine.multi_loop import train_multi
    from gaussianavatar_torch.parallel import mesh

    grp = mesh.group()
    # the JAX CLI seeds its host RNGs with 0; the networks' initial weights
    # draw from torch's default generator, one subject after the other
    torch.manual_seed(0)
    with contextlib.ExitStack() as stack:
        if quiet:
            stack.enter_context(contextlib.redirect_stdout(stack.enter_context(
                open(os.devnull, "w"))))
        train_multi(cfgs, saving_epochs, checkpoint_epochs,
                    device=device if grp is None else grp.device, max_steps=max_steps)


if __name__ == "__main__":
    main()
