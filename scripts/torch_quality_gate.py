"""The PyTorch port's quality gate: train an avatar on the synthetic dataset
with `python -m gaussianavatar_torch.train`, evaluate its saves with
`python -m gaussianavatar_torch.eval`, and hold the held-out PSNR to the
gates of scripts/quality_gate.py (whose stage-1 and stage-2 parts this
copies; it imports no JAX, so it runs where only the port is installed):

  1. the endpoint: PSNR of the final checkpoint >= --gate_psnr (41.0 dB at
     the canonical 512-query workload, 30 at the 256 fast gate);
  2. the tail mean: mean PSNR of the last 3 saves >= --gate_avg_psnr (41.5
     at 512, 30 at 256); averaging three late evals shrinks the endpoint's
     trajectory chaos;
  3. with --stage2: export the stage-1 endpoint's poses (`python -m
     gaussianavatar_torch.export_stage_1`), write the per-frame posmaps at
     --inp (`python -m gaussianavatar_torch.gen_pose_map_frames`), train
     stage 2 for epochs // 2 from the stage-1 endpoint, evaluate its end:
     stage-2 PSNR >= the stage-1 final PSNR (the larger of the endpoint
     and the parameter mean) - 1.0 dB at the canonical workload, - 1.5 dB
     otherwise.

The parameter mean of the last 3 saves ("SWA") is evaluated and recorded,
not gated. The canonical campaign:

    python scripts/torch_quality_gate.py --work output/torch_qg512 --query 512 --inp 128 [--stage2]

It writes <work>/curve.json (PSNR / SSIM per evaluated epoch),
<work>/quality_summary.json (gates, curve, SWA, stage 2) and
<work>/wall.json (training wall clock, steps and it/s over the training
runs of each stage, and the name and power limit of the card this
invocation ran on), and exits nonzero when a gate fails. It is resumable:
a run whose final checkpoint exists is not trained again, one without it
resumes from the newest save that holds the optimizer state
(`--checkpoint_epochs`), and evaluations already made are read from
curve.json and stage2_eval.json, so a campaign can span several processes
or machines (carry <work> across). A resumed stage-2 run takes the
decoder, geo_feature and the embeddings from stage 1 again, as the JAX
loop does (ROADMAP F10), so keep the stage-2 leg in one process. The
frozen-net pose-recovery probe of scripts/quality_gate.py is not ported.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from os.path import dirname, join

REPO = dirname(dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from gaussianavatar_torch.engine import checkpoint as ckpt  # noqa: E402


def sh(argv):
    print("+", " ".join(argv), flush=True)
    r = subprocess.run([sys.executable] + argv, cwd=REPO)
    if r.returncode != 0:
        raise SystemExit(f"step failed: {argv}")


def read_psnr(model_path):
    txt = open(join(model_path, "test_free", "results.txt")).read()
    return (
        float(txt.split("psnr:")[1].split()[0]),
        float(txt.split("ssim:")[1].split()[0]),
    )


def average_checkpoints(model_path, epochs, out_epoch):
    """Write the mean of several saves' network state_dicts (parameters and
    BatchNorm statistics, in float64, cast back) as iteration_{out_epoch}."""
    sds = [torch.load(join(ckpt.ckpt_dir(model_path, e), ckpt.CKPT_NAME), map_location="cpu",
                      weights_only=True) for e in epochs]
    avg = {k: (sum(sd[k].double() for sd in sds) / len(sds)).to(v.dtype)
           for k, v in sds[-1].items()}
    ckpt.save_state_dict(model_path, out_epoch, avg)


def card_of(device):
    """The card as nvidia-smi names it, with its power limit; "cpu" on the CPU."""
    if device == "cpu":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def steady_rate(metrics_path, since):
    """it/s between the first and last steps logged after time `since`
    (metrics.jsonl timestamps: the run's first step, its kernel builds and
    set-up are outside)."""
    steps = [json.loads(line) for line in open(metrics_path)]
    steps = [r for r in steps if "step" in r and r["t"] >= since]
    if len(steps) < 2:
        return None
    return (steps[-1]["step"] - steps[0]["step"]) / (steps[-1]["t"] - steps[0]["t"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=join(REPO, "output", "torch_quality_gate"))
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--query", type=int, default=256)
    ap.add_argument("--inp", type=int, default=64,
                    help="inp_posmap_size; the canonical workload is --query 512 --inp 128")
    ap.add_argument("--n_train", type=int, default=48)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--gate_psnr", type=float, default=None,
                    help="endpoint gate; default 41.0 at 512-query, 30.0 at 256")
    ap.add_argument("--gate_avg_psnr", type=float, default=None,
                    help="gate of the mean PSNR of the last 3 saves; default 41.5 at "
                         "512-query, 30.0 at 256")
    ap.add_argument("--train_flag", action="append", default=[],
                    help="extra training flag, repeatable, 'name=value' or bare 'name'")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--stage2", action="store_true",
                    help="then the stage-2 leg: export, posmaps, epochs // 2 of stage 2, eval")
    args = ap.parse_args(argv)
    canonical = args.query >= 512
    if args.gate_psnr is None:
        args.gate_psnr = 41.0 if canonical else 30.0
    if args.gate_avg_psnr is None:
        args.gate_avg_psnr = 41.5 if canonical else 30.0

    work = os.path.abspath(args.work)
    data = join(work, "data")
    out1 = join(work, "stage1")
    summary = {"gates": {}, "curve": []}

    os.makedirs(work, exist_ok=True)
    if not os.path.exists(join(data, "train", "smpl_parms.pth")):
        from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

        write_synthetic_dataset(
            data, n_train=args.n_train, n_test=args.n_test,
            image_size=args.image_size,
            body_kwargs={"n_rings": 48, "n_cols": 32},
            device=args.device,
        )

    # the port has no LPIPS yet: it trains as with --no_lpips and says so
    common = [
        "-s", data, "--dataset_type", "synthetic",
        "--query_posmap_size", str(args.query),
        "--inp_posmap_size", str(args.inp),
        "--batch_size", "2", "--device", args.device,
    ]
    for flag in args.train_flag:
        name, _, value = flag.partition("=")
        common.append("--" + name.lstrip("-"))
        if value:
            common.append(value)
    # save every eighth so the tail leaves >= 3 closely spaced saves; the
    # curve evaluates the quarter points
    save_every = max(args.epochs // 8, 1)

    def saved_epochs(out, last):
        # training saves only: the averaged checkpoint is iteration_{epochs + 1}
        net_dir = join(out, "net")
        if not os.path.isdir(net_dir):
            return []
        found = sorted(int(d.split("_")[1]) for d in os.listdir(net_dir)
                       if d.startswith("iteration_"))
        return [e for e in found if e <= last and (e % save_every == 0 or e == last)]

    def train_to(out, last, log_name, argv):
        """Train (or resume) `out` until its save of epoch `last` exists;
        each run's wall clock and steps go to <work>/<log_name>."""
        log = join(work, log_name)
        runs = json.load(open(log)) if os.path.exists(log) else []
        if last not in saved_epochs(out, last):
            resume = ckpt.latest_epoch(out, ckpt.TRAIN_NAME)
            iteration_at = lambda e: int(torch.load(join(ckpt.ckpt_dir(out, e), ckpt.TRAIN_NAME),
                                                    map_location="cpu",
                                                    weights_only=True)["iteration"])
            extra = ["--checkpoint_epochs", str(resume)] if resume is not None else []
            start_it = iteration_at(resume) if resume is not None else 0
            t0 = time.time()
            sh(["-m", "gaussianavatar_torch.train", "-m", out, *common, *argv,
                "--epochs", str(last), "--save_epoch", str(save_every),
                "--save_epochs", str(save_every - 1), *extra])
            runs.append({"resumed_from_epoch": resume, "from_iteration": start_it,
                         "to_iteration": iteration_at(last), "wall_s": time.time() - t0,
                         "steady_it_per_sec": steady_rate(join(out, "metrics.jsonl"), t0)})
            with open(log, "w") as f:
                json.dump(runs, f, indent=1)
        return runs

    runs = train_to(out1, args.epochs, "train_runs.json", ["--train_stage", "1"])
    epochs = saved_epochs(out1, args.epochs)
    curve_epochs = sorted({e for e in epochs if (e // save_every) % 2 == 0} | {epochs[-1]})
    curve_path = join(work, "curve.json")
    curve_cache = {}
    if os.path.exists(curve_path):
        curve_cache = {c["epoch"]: c for c in json.load(open(curve_path))}

    def evaluate(e):
        if e not in curve_cache:
            sh(["-m", "gaussianavatar_torch.eval", "-m", out1, "--epoch", str(e),
                "--device", args.device])
            p, s = read_psnr(out1)
            curve_cache[e] = {"epoch": e, "psnr": p, "ssim": s}
            with open(curve_path, "w") as f:
                json.dump([curve_cache[k] for k in sorted(curve_cache)], f)
        return curve_cache[e]

    for e in curve_epochs:
        c = evaluate(e)
        summary["curve"].append(c)
        print(f"[curve] epoch {e}: PSNR {c['psnr']:.2f} SSIM {c['ssim']:.4f}", flush=True)

    final_psnr = summary["curve"][-1]["psnr"]
    summary["gates"]["stage1_psnr"] = {
        "value": final_psnr, "gate": args.gate_psnr, "pass": final_psnr >= args.gate_psnr
    }

    K_AVG = 3
    tail = epochs[-min(K_AVG, len(epochs)):]
    tail_psnrs = [evaluate(e)["psnr"] for e in tail]
    tail_mean = sum(tail_psnrs) / len(tail_psnrs)
    print(f"[tail] mean PSNR over {tail}: {tail_mean:.2f} "
          f"(spread {max(tail_psnrs) - min(tail_psnrs):.2f} dB)", flush=True)
    summary["gates"]["stage1_tail_mean_psnr"] = {
        "value": tail_mean, "epochs": tail, "psnrs": tail_psnrs,
        "gate": args.gate_avg_psnr, "pass": tail_mean >= args.gate_avg_psnr,
    }

    # the parameter mean of the tail saves: recorded, not gated
    avg_path = join(work, "avg_eval.json")
    if len(epochs) >= 2:
        if os.path.exists(avg_path):
            avg = json.load(open(avg_path))
        else:
            avg_epoch = args.epochs + 1
            average_checkpoints(out1, tail, avg_epoch)
            sh(["-m", "gaussianavatar_torch.eval", "-m", out1, "--epoch", str(avg_epoch),
                "--device", args.device])
            p, s = read_psnr(out1)
            avg = {"epochs": tail, "psnr": p, "ssim": s}
            with open(avg_path, "w") as f:
                json.dump(avg, f)
        print(f"[swa] parameter mean of {avg['epochs']}: PSNR {avg['psnr']:.2f} "
              f"SSIM {avg['ssim']:.4f}", flush=True)
        summary["swa_experiment"] = avg
        final_psnr = max(final_psnr, avg["psnr"])

    stage2_runs = []
    if args.stage2:
        out2 = join(work, "stage2")
        ep2 = max(args.epochs // 2, 1)
        stage1_end = ckpt.ckpt_dir(out1, epochs[-1])
        if ep2 not in saved_epochs(out2, ep2):
            dev = ["--device", args.device]
            sh(["-m", "gaussianavatar_torch.export_stage_1", "-m", out1, "-s", data,
                "--epoch", str(epochs[-1]), *dev])
            sh(["-m", "gaussianavatar_torch.gen_pose_map_frames", "--source_path", data,
                "--synthetic", "--size", str(args.inp), *dev])
            if ckpt.latest_epoch(out2, ckpt.TRAIN_NAME) is not None:
                print("[stage2] resuming: the decoder, geo_feature and the embeddings come "
                      "from stage 1 again (ROADMAP F10)", flush=True)
        stage2_runs = train_to(out2, ep2, "stage2_runs.json",
                               ["--train_stage", "2", "--stage1_out_path", stage1_end])
        s2_path = join(work, "stage2_eval.json")
        if os.path.exists(s2_path):
            s2 = json.load(open(s2_path))
        else:
            sh(["-m", "gaussianavatar_torch.eval", "-m", out2, "--epoch", str(ep2),
                "--device", args.device])
            p, s = read_psnr(out2)
            s2 = {"epoch": ep2, "psnr": p, "ssim": s}
            with open(s2_path, "w") as f:
                json.dump(s2, f)
        print(f"[stage2] epoch {ep2}: PSNR {s2['psnr']:.2f} SSIM {s2['ssim']:.4f}", flush=True)
        # the margin of scripts/quality_gate.py: 1.0 dB at the canonical
        # 512-query workload, 1.5 dB at the 256 fast gate
        margin = 1.0 if canonical else 1.5
        summary["stage2"] = s2
        summary["gates"]["stage2_psnr"] = {
            "value": s2["psnr"], "stage1_final": final_psnr, "gate": final_psnr - margin,
            "pass": s2["psnr"] >= final_psnr - margin,
        }

    # over the training runs of this work directory (a resumed campaign has several)
    def wall_of(rs):
        steps = sum(r["to_iteration"] - r["from_iteration"] for r in rs)
        wall_s = sum(r["wall_s"] for r in rs)
        return {"steps": steps, "wall_s": wall_s,
                "wall_it_per_sec": steps / wall_s if wall_s else None, "runs": rs}

    wall = {**wall_of(runs), "card": card_of(args.device)}
    if stage2_runs:
        wall["stage2"] = wall_of(stage2_runs)
    with open(join(work, "wall.json"), "w") as f:
        json.dump(wall, f, indent=1)

    summary["pass"] = all(g["pass"] for g in summary["gates"].values())
    with open(join(work, "quality_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0 if summary["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
