"""Where the time of the port's training step (stage 1, or stage 2 with
`--stage 2`) goes, on one card; with `--lpips`, under the LPIPS term.

Writes chip_smoke.py's training data (8 synthetic frames of 512^2 from the
port's writer) into a temporary directory and runs the port's training CLI
(`gaussianavatar_torch.train.main`, canonical widths: query posmap 512,
bf16 decoder, B=2, 32px tiles, M=9) under torch.profiler. The stages are the
`train::*` ranges of engine/train_step.py, at `--steps_per_dispatch 1`
(a replayed CUDA graph records none of them) (decode, loss, backward,
optimizer, the whole step, and `train::lpips`, the LPIPS term's forward,
with `--lpips`; its backward lands in `train::backward`) and the `render::*`
ranges the rasterizer opens
(pose_gaussians, attributes, projection, binning, blend, untile, and on the
way back blend_bwd and scatter_bwd). Steps after the first `--warmup` count.
Per step it prints each stage's host time and the device time of the
kernels launched in it, then the step's wall time, the device-busy share
and the kernels by device time. With `--stage 2` a stage-1 run of 10 steps
first gives the stage-2 run its start (export, posmaps at 128), and the
profiled run is `--train_stage 2` (c_pose 64, nf 32), as chip_smoke.py's
phase 7. `--lpips` writes random weights of the exact LPIPS layout
(ops/lpips.random_lpips_weights, seed 0) under a project directory and
trains with them from the first step (`--lpips_start_iter 0`), as
chip_smoke.py's phase 8; the weights stand in for pretrained ones, whose
times are the same. `--aiap` trains with the AIAP regulariser (`--use_aiap`,
its term in `train::aiap` inside `train::loss`) and `--pos_encoding` with
the decoder's uv inputs encoded (`--pos_encoding 1`), as chip_smoke.py's
phase 9 (a). `--fused_decoder` trains through the fused decoder
(`--fused_decoder 1`, its kernels H-dstat, H-dfwd and H-dbwd), as
chip_smoke.py's phase 11. Last, the step's decode alone, forward and
backward, in `--steps` more rounds under the profiler on the same
configuration (the network freshly built from seed 0, the backward of a
random cotangent of its outputs): the device time of the forward's
kernels, and of the round's other kernels (the backward's), which the
step's ranges cannot separate (the decoder's backward runs inside
`train::backward`).

    python3 scripts/torch_train_profile.py [--steps 20] [--warmup 10] [--stage 2] [--lpips]
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
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=10)
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
    from torch_render_profile import range_times

    from gaussianavatar_torch import export_stage_1, gen_pose_map_frames, train as train_cli
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.ops.lpips import random_lpips_weights

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        data, out = os.path.join(work, "data"), os.path.join(work, "out")
        write_synthetic_dataset(data, n_train=8, n_test=1, image_size=512, device="cuda")
        # one dispatch a step: a replayed CUDA graph drops the record_function
        # ranges this script reads (the data's 4 batches an epoch never fill a
        # group of 8 anyway, but a larger set would)
        print("profiling at --steps_per_dispatch 1: the train::* and render::* ranges are "
              "recorded only where the step runs eagerly, not under a graph's replay")
        common = ["-s", data, "--dataset_type", "synthetic", "--pose_op_start_iter", "0",
                  "--no_lpips", "--quiet", "--steps_per_dispatch", "1"]
        argv = ["-m", out, "--train_stage", "1", "--max_steps", str(args.warmup + args.steps)]
        if args.stage == 2:
            stage1 = os.path.join(work, "out_stage1")
            train_cli.main(common + ["-m", stage1, "--max_steps", "10"])
            export_stage_1.main(["-m", stage1, "-s", data])
            gen_pose_map_frames.main(["--source_path", data, "--synthetic", "--size", "128"])
            argv = ["-m", out, "--train_stage", "2", "--max_steps", str(args.warmup + args.steps),
                    "--stage1_out_path", os.path.join(stage1, "net", "iteration_3")]
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
        decode = decode_alone(argv, args.warmup, args.steps, acts, range_times)
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    steps = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "train::step" and e.device_type == cpu)
    window = steps[args.warmup:]
    since, until = window[0][0], window[-1][1]
    n = len(window)
    host, dev, kernels, how = range_times(
        [e for e in events if e.time_range.start < until], ("train::", "render::"), since)
    wall_ms = (until - since) / 1e3
    busy_ms = sum(kernels.values())
    terms = [name for name, on in (("LPIPS", args.lpips), ("AIAP", args.aiap),
                                   ("the positional encoding", args.pos_encoding),
                                   ("the fused decoder", args.fused_decoder)) if on]
    print(f"stage-{args.stage} training{' with ' + ', '.join(terms) if terms else ''}, "
          "B=2 of 512x512, "
          f"canonical widths, steps {args.warmup + 1}-"
          f"{args.warmup + n} under torch.profiler, per step, on {card}:")
    print(f"  {'range':26s} {'host ms':>9s} {'device ms':>10s}  (device: {how})")
    for name in sorted(host, key=lambda k: -dev[k]):
        print(f"  {name:26s} {host[name] / n:9.3f} {dev[name] / n:10.3f}")
    print(f"  step: {wall_ms / n:.3f} ms wall under the profiler ({n * 1e3 / wall_ms:.2f} it/s); "
          f"device busy {busy_ms / n:.3f} ms per step, {100 * busy_ms / wall_ms:.1f}% of the wall")
    print("kernels by device time, per step:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms / n:8.3f} ms  {100 * ms / busy_ms:5.1f}%  {name[:90]}")
    rows, (d_host, d_dev, d_kernels) = decode
    # the backward's kernels run on autograd's thread, outside its range's
    # device span: its device time is the round's kernels less the forward's
    fwd = d_dev["decode::forward"]
    dev_ms = {"decode::forward": fwd, "decode::backward": sum(d_kernels.values()) - fwd}
    print(f"the decode alone ({'fused' if args.fused_decoder else 'reference'} decoder, "
          f"{rows} rows), {args.steps} rounds after {args.warmup}, per round, on {card}:")
    for name in ("decode::forward", "decode::backward"):
        print(f"  {name:26s} {d_host[name] / args.steps:9.3f} host ms "
              f"{dev_ms[name] / args.steps:10.3f} device ms")
    print("  its kernels by device time, per round:")
    for name, ms in sorted(d_kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms / args.steps:8.3f} ms  {name[:90]}")
    return 0


def decode_alone(argv, warmup, rounds, acts, range_times):
    """The training configuration's decode, forward then backward, `warmup`
    + `rounds` times under the profiler -> (rows it decodes, (host ms,
    device ms, device ms by kernel) of the decode::forward and
    decode::backward ranges over the last `rounds`)."""
    from torch.profiler import record_function

    from gaussianavatar_torch.config import build_parser, extract_config
    from gaussianavatar_torch.engine.setup import setup_avatar

    cfg = extract_config(build_parser().parse_known_args(argv)[0])
    torch.manual_seed(0)
    bundle = setup_avatar(cfg, device="cuda", train=True)
    net, assets = bundle.net.train(), bundle.assets
    B = cfg.model.batch_size
    inp = None
    if cfg.model.train_stage == 2:
        S = cfg.model.inp_posmap_size
        inp = torch.rand((B, 3, S, S), generator=torch.Generator().manual_seed(0)).cuda()
    outs = net.decode(assets, 1 if inp is None else B, inp)[:3]
    gen = torch.Generator(device="cuda").manual_seed(1)
    cots = [torch.randn(o.shape, device="cuda", generator=gen) for o in outs]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(warmup + rounds):
            torch.cuda.synchronize()
            with record_function("decode::forward"):
                outs = net.decode(assets, 1 if inp is None else B, inp)[:3]
            with record_function("decode::backward"):
                torch.autograd.backward(outs, cots)
            net.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    starts = sorted(e.time_range.start for e in events
                    if e.name == "decode::forward" and e.device_type == cpu)
    host, dev, kernels, _ = range_times(events, ("decode::",), starts[warmup])
    return outs[0].shape[0] * outs[0].shape[1], (host, dev, kernels)


if __name__ == "__main__":
    sys.exit(main())
