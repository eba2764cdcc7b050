"""How far a stage-2 `train --dp 2` run leaves `--dp 1` on one card, read on
the first step's loss and on the BatchNorm running statistics it saves,
for sound runs and for control runs whose ranks keep their own share's
BatchNorm statistics: the readings behind chip_smoke.py's TOL_DP_BN.

Writes chip_smoke.py's training data (8 synthetic frames of 512^2 from the
port's writer) into a temporary directory. For each of `--trials` stage-1
saves (chip_smoke's 30 stage-1 steps at the canonical widths, each a new
run, so the saves differ by the atomics of `index_add_`), exports its poses
and the posmaps at 128, then trains stage 2 at the f32 decoder from it:
with the reference decoder `--dp 1`, `--dp 2` and `--dp 2` whose BatchNorm
layers all take their rank's own statistics (`no_bn_sync`), one step each,
then `--dp 1` and `--dp 2` for three steps; with `--fused_decoder 1` the
same one-step runs, the control's ranks skipping only the fused decoder's
statistics all-reduce (`no_decoder_sync`). Every run goes through
`gaussianavatar_torch.train.main` (chip_smoke._dp_run; a rank is patched
through chip_smoke's rank hook, which this script installs in its spawned
ranks as chip_smoke.py does). Per case it prints the first step's relative
loss difference from `--dp 1` and the largest BatchNorm running-statistic
difference (chip_smoke._bn_apart), then one JSON line of them.

    python3 scripts/torch_dp_bn_probe.py [--trials 2]
"""

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# (decoder, control fault, steps of the extra sound runs or None)
CASES = (("reference", "no_bn_sync", chip_smoke.DP2_STEPS), ("fused", "no_decoder_sync", None))


def main():
    import torch

    from gaussianavatar_torch import export_stage_1, gen_pose_map_frames, train as train_cli
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine import checkpoint as ckpt

    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_dp_bn_probe: needs a CUDA device")
    card = chip_smoke.phase_setup()
    summary = {"card": card, "trials": []}
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        data = os.path.join(work, "data")
        write_synthetic_dataset(data, n_train=8, n_test=4, image_size=512, device="cuda")
        for trial in range(args.trials):
            out1 = os.path.join(work, f"stage1_{trial}")
            train_cli.main(chip_smoke._train_argv(data, out1)
                           + ["--max_steps", str(chip_smoke.TRAIN_STEPS)])
            stage1 = ckpt.ckpt_dir(out1, ckpt.latest_epoch(out1, ckpt.TRAIN_NAME))
            export_stage_1.main(["-m", out1, "-s", data])
            gen_pose_map_frames.main(["--source_path", data, "--synthetic", "--size", "128"])
            readings = {}
            for decoder, fault, more in CASES:
                argv = lambda out: ["-s", data, "-m", out, "--train_stage", "2",
                                    "--stage1_out_path", stage1, "--dataset_type", "synthetic",
                                    "--no_lpips", "--bf16_decoder", "0", "--fused_decoder",
                                    "1" if decoder == "fused" else "0"]
                run = lambda name, dp, steps, flt=None: chip_smoke._dp_run(
                    f"trial {trial}, {decoder} decoder", argv,
                    os.path.join(work, f"t{trial}_{decoder}_{name}"), dp, steps, flt)
                dp1, dp2, ctrl = run("dp1", 1, 1), run("dp2", 2, 1), run(fault, 2, 1, fault)
                r = {"loss_sound": chip_smoke._apart(dp1, dp2, 1),
                     "loss_control": chip_smoke._apart(dp1, ctrl, 1),
                     "bn_sound": chip_smoke._bn_apart(dp1, dp2),
                     "bn_control": chip_smoke._bn_apart(dp1, ctrl)}
                if more:
                    r[f"bn_sound_{more}_steps"] = chip_smoke._bn_apart(
                        run(f"dp1_{more}", 1, more), run(f"dp2_{more}", 2, more))
                readings[decoder] = r
                print(f"trial {trial}, {decoder} decoder ({fault} control): "
                      + ", ".join(f"{k} {v:.3e}" for k, v in r.items()), flush=True)
            summary["trials"].append(readings)
    print(json.dumps(summary))


if __name__ == "__mp_main__" and os.environ.get(chip_smoke.RANK_HOOK_ENV):
    chip_smoke._rank_hooks(json.loads(os.environ[chip_smoke.RANK_HOOK_ENV]))

if __name__ == "__main__":
    main()
