"""How far a stage-1 `train --dp 2` run leaves `--dp 1` over its first
steps on one card, for sound runs and for control runs whose ranks break
one piece of the data-parallel step: the readings behind chip_smoke.py's
phase-10 limits.

Writes chip_smoke.py's training data (8 synthetic frames of 512^2 from the
port's writer) into a temporary directory, then trains from seed 0 at the
canonical widths (query posmap 512, B=2, 32 px tiles), with the bf16
decoder (the default) and with the f32 one: `--dp 1` twice, `--dp 2`
twice (two ranks sharing the card over gloo), `--dp 2` whose BatchNorm
layers take their rank's own statistics (`no_bn_sync`), and `--dp 2`
without the gradient all-reduce (`no_grad_sync`). Every run goes through
`gaussianavatar_torch.train.main` and records the global batch's loss at
every step (chip_smoke._dp_run; a rank is patched through chip_smoke's
rank hook, which this script installs in its spawned ranks as
chip_smoke.py does). Per run it prints the largest relative difference of
a step's loss from the first `--dp 1` run's, over the first step and over
all steps, then one JSON line of them.

    python3 scripts/torch_dp_trajectory.py [--steps 10]
"""

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

RUNS = (("dp1", 1, None), ("dp1_again", 1, None), ("dp2", 2, None), ("dp2_again", 2, None),
        ("dp2_no_bn_sync", 2, "no_bn_sync"), ("dp2_no_grad_sync", 2, "no_grad_sync"))


def main():
    import torch

    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_dp_trajectory: needs a CUDA device")
    card = chip_smoke.phase_setup()
    summary = {"card": card, "steps": args.steps}
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        data = os.path.join(work, "data")
        write_synthetic_dataset(data, n_train=8, n_test=4, image_size=512, device="cuda")
        for dtype, flag in (("bf16", "1"), ("f32", "0")):
            argv = lambda out: chip_smoke._train_argv(data, out) + ["--bf16_decoder", flag]
            runs = {name: chip_smoke._dp_run(f"stage 1 ({dtype})", argv,
                                             os.path.join(work, f"{dtype}_{name}"), dp,
                                             args.steps, fault)
                    for name, dp, fault in RUNS}
            ref = runs["dp1"]
            summary[dtype] = {}
            for name, run in runs.items():
                first, traj = chip_smoke._apart(ref, run, 1), chip_smoke._apart(ref, run)
                summary[dtype][name] = {"first": first, "trajectory": traj,
                                        "totals": run["totals"]}
                print(f"  {dtype} {name}: step 1 {first:.2e}, largest over steps 1-{args.steps} "
                      f"{traj:.2e}; losses " + ", ".join(f"{x:.6f}" for x in run["totals"]))
    print(json.dumps(summary))


if __name__ == "__mp_main__" and os.environ.get(chip_smoke.RANK_HOOK_ENV):
    chip_smoke._rank_hooks(json.loads(os.environ[chip_smoke.RANK_HOOK_ENV]))

if __name__ == "__main__":
    main()
