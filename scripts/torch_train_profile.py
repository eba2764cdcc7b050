"""Where the time of the port's training step (stage 1, or stage 2 with
`--stage 2`) goes, on one card; with `--lpips`, under the LPIPS term.

Writes chip_smoke.py's training data (16 synthetic frames of 512^2 from the
port's writer: 8 batches an epoch, one dispatch of S = 8 steps) into a
temporary directory and runs the port's training CLI
(`gaussianavatar_torch.train.main`, canonical widths: query posmap 512,
bf16 decoder, B=2, 32px tiles, M=9, the default S) under torch.profiler.
The first dispatch runs eagerly and captures the graph that every later one
replays. The stages are the program's spans (utils/spans.py), read on the
device from their marker kernels, which a replayed graph runs too: the
`train::*` spans of engine/train_step.py (decode, the decoder's backward
`train::decode_bwd`, loss, backward, optimizer, the whole step, the
dispatch's feeds and replay, and `train::lpips`, the LPIPS term's forward,
with `--lpips`; its backward lands in `train::backward`) and the `render::*`
spans the rasterizer opens (pose_gaussians, attributes, projection, binning,
blend, untile, and on the way back blend_bwd and scatter_bwd). Steps after
the first `--warmup` count (take both multiples of 8: a group cut short by
`--max_steps` runs step by step). Per step it prints each span's device busy
time (its kernels, copies and fills) and the time inside it in which the
device ran nothing, then the step's device time, the busy share and the
kernels by device time. With `--stage 2` a stage-1 run of 10 steps first
gives the stage-2 run its start (export, posmaps at 128), and the profiled
run is `--train_stage 2` (c_pose 64, nf 32), as chip_smoke.py's phase 7.
`--lpips` writes random weights of the exact LPIPS layout
(ops/lpips.random_lpips_weights, seed 0) under a project directory and
trains with them from the first step (`--lpips_start_iter 0`), as
chip_smoke.py's phase 8; the weights stand in for pretrained ones, whose
times are the same. `--aiap` trains with the AIAP regulariser (`--use_aiap`,
its term in `train::aiap` inside `train::loss`) and `--pos_encoding` with
the decoder's uv inputs encoded (`--pos_encoding 1`), as chip_smoke.py's
phase 9 (a). `--fused_decoder` trains through the fused decoder
(`--fused_decoder 1`, its kernels H-dstat, H-dfwd and H-dbwd), as
chip_smoke.py's phase 11.

    python3 scripts/torch_train_profile.py [--steps 32] [--warmup 16] [--stage 2] [--lpips]
        [--aiap] [--pos_encoding] [--fused_decoder]
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--stage", type=int, default=1, choices=[1, 2])
    ap.add_argument("--lpips", action="store_true",
                    help="train with the LPIPS term (random weights of the exact layout)")
    ap.add_argument("--aiap", action="store_true", help="train with --use_aiap")
    ap.add_argument("--pos_encoding", action="store_true", help="train with --pos_encoding 1")
    ap.add_argument("--fused_decoder", action="store_true", help="train with --fused_decoder 1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: needs CUDA", file=sys.stderr)
        return 2
    from gaussianavatar_torch import export_stage_1, gen_pose_map_frames, train as train_cli
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.ops.lpips import random_lpips_weights
    from gaussianavatar_torch.utils.spans import device_spans, span_times, trace_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        data, out = os.path.join(work, "data"), os.path.join(work, "out")
        write_synthetic_dataset(data, n_train=16, n_test=1, image_size=512, device="cuda")
        common = ["-s", data, "--dataset_type", "synthetic", "--pose_op_start_iter", "0",
                  "--no_lpips", "--quiet"]
        argv = ["-m", out, "--train_stage", "1", "--max_steps", str(args.warmup + args.steps)]
        if args.stage == 2:
            stage1 = os.path.join(work, "out_stage1")
            train_cli.main(common + ["-m", stage1, "--max_steps", "10"])
            export_stage_1.main(["-m", stage1, "-s", data])
            gen_pose_map_frames.main(["--source_path", data, "--synthetic", "--size", "128"])
            argv = ["-m", out, "--train_stage", "2", "--max_steps", str(args.warmup + args.steps),
                    "--stage1_out_path", os.path.join(stage1, "net", "iteration_2")]
        argv = common + argv
        if args.lpips:
            proj = os.path.join(work, "proj")
            os.makedirs(os.path.join(proj, "assets", "lpips"))
            np.savez(os.path.join(proj, "assets", "lpips", "lpips_alex.npz"),
                     **random_lpips_weights(0))
            argv = [a for a in argv if a != "--no_lpips"] + [
                "--project_path", proj, "--lpips_start_iter", "0"]
        argv += ["--use_aiap"] * args.aiap + ["--pos_encoding", "1"] * args.pos_encoding \
            + ["--fused_decoder", "1"] * args.fused_decoder
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            train_cli.main(argv)
            torch.cuda.synchronize()
    ops = trace_ops(prof)
    steps = device_spans(ops)["train_step"][args.warmup:]
    since, until = steps[0][0], steps[-1][1]
    n = len(steps)
    times = span_times(ops, since, until)
    inside = [o for o in ops if since <= o[1] < until]
    kernels = {}
    for name, _, d in inside:
        kernels[name] = kernels.get(name, 0.0) + d / 1e3
    wall_ms = (until - since) / 1e3
    busy_ms = times["train_step"][1] / 1e3
    terms = [name for name, on in (("LPIPS", args.lpips), ("AIAP", args.aiap),
                                   ("the positional encoding", args.pos_encoding),
                                   ("the fused decoder", args.fused_decoder)) if on]
    print(f"stage-{args.stage} training{' with ' + ', '.join(terms) if terms else ''}, "
          "B=2 of 512x512, canonical widths, the default dispatch, "
          f"steps {args.warmup + 1}-{args.warmup + n} under torch.profiler, per step, on {card}:")
    print(f"  {'span':26s} {'per step':>8s} {'busy ms':>9s} {'idle ms':>9s}")
    for name, (count, busy, idle) in sorted(times.items(), key=lambda kv: -kv[1][1]):
        print(f"  {name:26s} {count / n:8.2f} {busy / 1e3 / n:9.3f} {idle / 1e3 / n:9.3f}")
    print(f"  step: {wall_ms / n:.3f} ms on the device from the first step's start to the last "
          f"one's end ({n * 1e3 / wall_ms:.2f} it/s); busy in train::step {busy_ms / n:.3f} ms "
          f"per step, {100 * busy_ms / wall_ms:.1f}% of it")
    print("device operations by time, per step:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms / n:8.3f} ms  {100 * ms / wall_ms:5.1f}%  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
