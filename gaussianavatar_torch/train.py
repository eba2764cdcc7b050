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
and unused, as in the JAX train.py.

    python -m gaussianavatar_torch.train ... --dp 2 [--batch_size 4] [--device cpu]

`--dp N` trains data-parallel over frames (parallel/mesh.py): N ranks,
spawned by this one command, each on its shard of every global batch (the
batch size must be a multiple of N), on NCCL when each rank has a card of
its own and on gloo when they share one or run on the CPU. Rank 0 writes
the outputs; the run's `kernel_launches` event in metrics.jsonl sums every
rank's. A rank that fails fails the command.

    python -m gaussianavatar_torch.train ... --pos_encoding 1 --use_aiap
    python -m gaussianavatar_torch.train ... --profile_dir <dir> [--max_steps N]

`--pos_encoding 1` NeRF-encodes the decoder's uv inputs; `--use_aiap` adds
the AIAP regulariser over a k=5 neighbour graph of the canonical points.
`--profile_dir` runs `--max_steps` steps (20 when not given) under
`torch.profiler` (CPU and, on the card, CUDA activities) and writes a
Chrome trace into the directory, with the step's `train::*` and
`render::*` spans (with `--dp`, rank 0's; utils/spans.py). The run is
traced as configured: a group of `--steps_per_dispatch` steps replayed as
a CUDA graph shows its spans on the device only, as the begin and end
marker kernels `ga_span__<span>__b` / `__e` around each span's kernels
(utils/spans.device_spans pairs them).

    python -m gaussianavatar_torch.train ... [--init torch]
    python -m gaussianavatar_torch.train ... [--ragged 0 --auto_cascade 0]

The defaults are the JAX CLI's. The network starts as the JAX package's
`init_state(PRNGKey(0))`, value for value (`--init flax`,
models/init.py); `--init torch` takes torch's own layer initialisation.
Above 256 queries training keeps the JAX loop's need table and adaptive
footprint (engine/need_table.py: per-tile row caps from the saturation
probe, the footprint M 9 <-> 4) unless `--ragged 0` or `--auto_cascade 0`
is given (config.resolve_train_raster_defaults; the run prints a note).

    python -m gaussianavatar_torch.train ... --steps_per_dispatch 8

`--steps_per_dispatch S` (8 by default, as in the JAX package) runs every
full group of S steps within an epoch as one dispatch: on the card one
replay of a CUDA graph that holds S whole training steps (forward, the
kernels, loss, backward, both optimizers), captured after the first such
group ran eagerly, and again when a gate flips; a capture that fails
stops the run. A group cut short by the epoch's end or `--max_steps` runs
step by step; the log and the debug dumps follow the JAX loop's group
rule. Under `--dp` a group's steps run eagerly (the ranks' collectives
cannot be captured); on the CPU they run one after another.

LPIPS: with weights under `<project_path>/assets/lpips/` (or the
repository's), `lpips_alex.npz` or the raw `alexnet*.pth` + `alex.pth` pair
(ops/lpips.try_load_lpips), the loss gains 0.2 * LPIPS after
`--lpips_start_iter` epochs (30); `--no_lpips` turns it off. metrics.jsonl
records which (the `lpips` event).
"""

import os
import sys
from argparse import ArgumentParser


def parse_args(argv=None):
    """The command line -> (args, cfg)."""
    from gaussianavatar_torch.config import (
        build_parser, extract_config, resolve_train_raster_defaults,
    )
    from gaussianavatar_torch.models.avatar import DEFAULT_INIT, INITS

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
    parser.add_argument("--init", choices=INITS, default=DEFAULT_INIT,
                        help="the network's initialisation (models/avatar.AvatarNet)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    cfg = extract_config(args)
    args.raster_notes = resolve_train_raster_defaults(cfg, args)
    return args, cfg


def main(argv=None, timeout_s=None):
    """`timeout_s` bounds a `--dp` run: its ranks are stopped and the call
    raises if they have not all finished by then."""
    from gaussianavatar_torch.engine.inference import require_device
    from gaussianavatar_torch.engine.logging_utils import safe_state

    args, cfg = parse_args(argv)
    require_device(args.device)
    stdout = safe_state(args.quiet)
    try:
        if args.dp > 1:
            from gaussianavatar_torch.parallel import mesh

            mesh.check_batch(cfg.model.batch_size, args.dp)
            mesh.spawn_ranks(run_training, args.dp, args.device, (args, cfg),
                             timeout_s=timeout_s)
        else:
            run_training(args, cfg)
    finally:
        sys.stdout = stdout


def run_training(args, cfg):
    """The training run of `main`, in this process or in one rank of a
    data-parallel group (on the group's device)."""
    import torch

    from gaussianavatar_torch.config import ignored_flags_note
    from gaussianavatar_torch.engine.logging_utils import safe_state
    from gaussianavatar_torch.engine.loop import train
    from gaussianavatar_torch.ops.lpips import try_load_lpips
    from gaussianavatar_torch.parallel import mesh

    grp = mesh.group()
    device = args.device if grp is None else grp.device
    saving_epochs = sorted(set(args.save_epochs + [cfg.opt.epochs]))
    if grp is not None:
        # a spawned rank: main's safe_state (timestamps, --quiet, the seeds)
        # did not reach this process
        safe_state(args.quiet)
    torch.autograd.set_detect_anomaly(args.detect_anomaly)
    print(ignored_flags_note())
    for note in getattr(args, "raster_notes", ()):
        print(note)
    print("Optimizing " + cfg.model.model_path)
    lpips_fn, lpips_note = None, None
    if args.no_lpips:
        lpips_note = "disabled (--no_lpips)"
    else:
        lpips_fn = try_load_lpips(cfg.model.project_path, device=device)
        if lpips_fn is None:
            print("LPIPS weights not found; training without the LPIPS term")
    run = lambda max_steps: train(cfg, saving_epochs, device=device,
                                  max_steps=max_steps, lpips_note=lpips_note,
                                  checkpoint_epochs=args.checkpoint_epochs,
                                  lpips_fn=lpips_fn, init=args.init)
    if args.profile_dir and (grp is None or grp.rank == 0):
        trace = profiled(run, args.profile_dir, args.max_steps or 20, device)
        print("profiler trace written to", trace)
    elif args.profile_dir:
        run(args.max_steps or 20)
    else:
        run(args.max_steps)
    print("\nTraining complete.")


def profiled(run, profile_dir: str, max_steps: int, device: str) -> str:
    """run(max_steps) under torch.profiler (CPU activities, and CUDA ones on
    the card) -> the Chrome trace it wrote into `profile_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        run(max_steps)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


if __name__ == "__main__":
    main()
