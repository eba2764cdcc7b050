"""How far a stage-1 `train --dp 2` run leaves `--dp 1` over its first
steps on one card, for sound runs and for control runs whose ranks break
one piece of the data-parallel step: the readings behind chip_smoke.py's
phase-10 limits.

Writes chip_smoke.py's training data (8 synthetic frames of 512^2 from the
port's writer) into a temporary directory, then trains from each seed of
`--seeds` (the initial network's; the CLIs' is 0) at the canonical widths
(query posmap 512, B=2, 32 px tiles), with the decoders of `--dtypes`
(bf16, the default, and f32), the runs of `--runs` (all by default):
`--dp 1` twice, `--dp 2` twice (two ranks sharing the card over gloo),
`--dp 2` whose BatchNorm layers take their rank's own statistics
(`no_bn_sync`), `--dp 2` without the gradient all-reduce
(`no_grad_sync`), and `--dp 1` and `--dp 2` under torch's deterministic
algorithms (`dp1_det`, `dp2_det`, the pair phase 10 holds at f32). Every
run goes through `gaussianavatar_torch.train.main` and records the global
batch's loss at every step (chip_smoke._dp_run; a rank is patched through
chip_smoke's rank hook, which this script installs in its spawned ranks as
chip_smoke.py does). Per run it prints the largest relative difference of
a step's loss from the reference run's (`dp1_det` where it ran, else
`dp1`), over the first step and over all steps, then one JSON line of
them.

    python3 scripts/torch_dp_trajectory.py [--steps 10] [--seeds 0 1 2] [--dtypes f32] \
        [--runs dp1_det dp2_det dp1 dp1_again dp2_no_grad_sync]
"""

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

RUNS = {"dp1": (1, None, False), "dp1_again": (1, None, False), "dp2": (2, None, False),
        "dp2_again": (2, None, False), "dp2_no_bn_sync": (2, "no_bn_sync", False),
        "dp2_no_grad_sync": (2, "no_grad_sync", False), "dp1_det": (1, None, True),
        "dp2_det": (2, None, True)}
DTYPES = {"bf16": "1", "f32": "0"}


def main():
    import torch

    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--dtypes", nargs="+", choices=list(DTYPES), default=list(DTYPES))
    ap.add_argument("--runs", nargs="+", choices=list(RUNS), default=list(RUNS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_dp_trajectory: needs a CUDA device")
    card = chip_smoke.phase_setup()
    summary = {"card": card, "steps": args.steps}
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        data = os.path.join(work, "data")
        write_synthetic_dataset(data, n_train=8, n_test=4, image_size=512, device="cuda")
        for seed in args.seeds:
            for dtype in args.dtypes:
                argv = lambda out: chip_smoke._train_argv(data, out) + [
                    "--bf16_decoder", DTYPES[dtype]]
                runs = {}
                for name in args.runs:
                    dp, fault, det = RUNS[name]
                    runs[name] = chip_smoke._dp_run(
                        f"stage 1 ({dtype}, seed {seed})", argv,
                        os.path.join(work, f"{dtype}_{seed}_{name}"), dp, args.steps, fault,
                        deterministic=det, seed=seed)
                ref = runs["dp1_det"] if "dp1_det" in runs else runs["dp1"]
                key = f"{dtype}_seed{seed}"
                summary[key] = {}
                for name, run in runs.items():
                    first, traj = chip_smoke._apart(ref, run, 1), chip_smoke._apart(ref, run)
                    summary[key][name] = {"first": first, "trajectory": traj,
                                          "totals": run["totals"]}
                    print(f"  {key} {name}: step 1 {first:.2e}, largest over steps "
                          f"1-{args.steps} {traj:.2e}; losses "
                          + ", ".join(f"{x:.6f}" for x in run["totals"]))
    print(json.dumps(summary))


if __name__ == "__mp_main__" and os.environ.get(chip_smoke.RANK_HOOK_ENV):
    chip_smoke._rank_hooks(json.loads(os.environ[chip_smoke.RANK_HOOK_ENV]))

if __name__ == "__main__":
    main()
