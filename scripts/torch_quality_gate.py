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
     otherwise;
  4. with --pose_opt: frozen-net pose recovery (`pose_recovery`, the leg
     of scripts/quality_gate.py step for step): freeze the stage-1
     endpoint's net (lr_net = lr_geomfeat = 0; BatchNorm statistics still
     move in training mode), perturb the pose embeddings with N(0,
     --pose_noise) outside the global orientation, refine them with
     SparseAdam at --pose_lr for --pose_epochs epochs, and require
     recovered_fraction >= 0.5 of the loss excess over the frozen net's
     floor at the true poses, and a render-space PSNR(refined, true) >=
     PSNR(perturbed, true) + 6 dB or >= 35 dB.

The parameter mean of the last 3 saves ("SWA") is evaluated and recorded,
not gated. The canonical campaign:

    python scripts/torch_quality_gate.py --work output/torch_qg512 --query 512 --inp 128 \
        [--stage2] [--pose_opt --pose_lr 1e-2]

With `--subjects N` (N > 1) stage 1 trains N copies of the subject side by
side through `python -m gaussianavatar_torch.train_multi` (subject s starts
from JAX's `init_state(PRNGKey(s))` and is shuffled by a loader seeded s;
every subject keeps its own need table and they share the worst one's
footprint), and each subject is held to gates 1 and 2 on its own saves
under <work>/multi/<name>/; its curve and parameter mean are cached in
curve_<name>.json and avg_eval_<name>.json, and the summary adds, per
subject, its `init`, need-table and footprint events. Stage 1 only.

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
pose-recovery leg's result is kept in pose_recovery.json beside its
settings; wall.json records its steps and wall clock.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from os.path import dirname, join

import numpy as np

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


# the JAX leg's settings: w_rgl of the refinement steps, the floor epoch's
# shuffle seed, the render check's shuffle seed and frame count
POSE_W_RGL = 0.85
FLOOR_SEED = 10**6
RENDER_SEED, RENDER_FRAMES = 7, 8


def pose_noise(shape, scale: float) -> np.ndarray:
    """The perturbation of scripts/quality_gate.py: N(0, scale) from
    default_rng(0), float32, zero on the global orientation (columns :3)."""
    noise = np.random.default_rng(0).normal(scale=scale, size=shape).astype(np.float32)
    noise[:, :3] = 0
    return noise


def pose_recovery(out1, epoch, device="cuda", pose_lr=2e-2, pose_epochs=40, noise_scale=0.3):
    """The frozen-net pose-recovery leg on the stage-1 save `out1`/net/
    iteration_`epoch` -> (the gate's record, with the JAX leg's keys; the
    network's state_dict after the refinement). Every step runs the port's
    train step (H-fwd, then H-bwd on the way back); the render check draws
    through the stage-1 canonical cache (H-fwd)."""
    from gaussianavatar_torch.config import Config
    from gaussianavatar_torch.data.dataset import BatchLoader
    from gaussianavatar_torch.engine.inference import make_cached_render_fn, precompute_canonical
    from gaussianavatar_torch.engine.loop import DROP_KEYS, build_gt_bank
    from gaussianavatar_torch.engine.optim import build_optimizer
    from gaussianavatar_torch.engine.setup import setup_avatar
    from gaussianavatar_torch.engine.train_step import TrainState, make_train_step
    from gaussianavatar_torch.ops.rasterize import raster_config
    from gaussianavatar_torch.ops.ssim import psnr

    cfg = Config.load(join(out1, "cfg_args.json"))
    cfg.opt.lr_net = 0.0
    cfg.opt.lr_geomfeat = 0.0
    cfg.opt.lr_pose = pose_lr
    bundle = setup_avatar(cfg, device=device, train=True)
    dataset, net = bundle.frames, bundle.net
    H, W = dataset.image_hw()
    bs = cfg.model.batch_size
    state = TrainState(net, build_optimizer(net, cfg.opt, len(dataset) // bs, train_stage=1))
    ckpt.load_train_state(out1, epoch, state)
    white = (1.0, 1.0, 1.0)  # the JAX leg renders on white whatever the config
    step = make_train_step(net, bundle.body_model, bundle.assets, cfg.opt, H, W, white,
                           raster_config(cfg, train=True), build_gt_bank(dataset, device))

    def run_epoch(seed):
        tot, n = 0.0, 0
        for batch in BatchLoader(dataset, bs, seed=seed):
            feed = {k: v for k, v in batch.items() if k not in DROP_KEYS}
            terms, _ = step(state, feed, POSE_W_RGL, 1.0, 0.0)
            tot += float(terms["total"])
            n += 1
        return tot * bs / len(dataset), n

    clone = lambda sd: {k: v.detach().clone() for k, v in sd.items()}
    # the loss floor at the TRUE embeddings, on a copy of the state: the
    # network, the optimizer's moments and counts and the iteration go back
    true_sd = clone(net.state_dict())
    opt_sd = {g: {k: clone(v) if isinstance(v, dict) else
                  (v.clone() if torch.is_tensor(v) else v) for k, v in gs.items()}
              for g, gs in state.optimizer.state_dict().items()}
    iteration = state.iteration
    loss_floor, _ = run_epoch(FLOOR_SEED)
    net.load_state_dict(true_sd)
    state.optimizer.load_state_dict(opt_sd)
    state.iteration = iteration

    true_pose = true_sd["pose_embedding"].cpu().numpy()
    noise = pose_noise(true_pose.shape, noise_scale)
    with torch.no_grad():
        net.pose_embedding.copy_(torch.as_tensor(true_pose + noise))
    pert = (net.pose_embedding.detach().clone(), net.transl_embedding.detach().clone())

    n_steps, losses = 0, []
    for i in range(pose_epochs):
        loss, n = run_epoch(i)
        losses.append(loss)
        n_steps += n
    refined_sd = clone(net.state_dict())
    refined = refined_sd["pose_embedding"].cpu().numpy()
    d_init = float(np.abs(noise).mean())
    d_ref = float(np.abs(refined - true_pose).mean())
    l0, l1 = losses[0], losses[-1]
    recovered = (l0 - l1) / max(l0 - loss_floor, 1e-9)

    # render space: the canonical cache of the frozen net at its true
    # statistics, posed by each set of embeddings
    net.load_state_dict(true_sd)
    net.eval()
    cache = precompute_canonical(net, bundle.assets)
    render = make_cached_render_fn(net, bundle.body_model, bundle.assets, H, W, white,
                                   raster_config(cfg, train=False))
    tables = {"true": (true_sd["pose_embedding"], true_sd["transl_embedding"]), "pert": pert,
              "refined": (refined_sd["pose_embedding"], refined_sd["transl_embedding"])}
    batches = list(BatchLoader(dataset, bs, seed=RENDER_SEED))[:max(RENDER_FRAMES // bs, 1)]
    pp, pr = [], []
    for batch in batches:
        feed = {k: v for k, v in batch.items() if k not in DROP_KEYS}
        idx = torch.as_tensor(feed["pose_idx"]).long()
        img = {name: render(cache, dict(feed, pose_data=pose[idx.to(pose.device)],
                                        transl_data=transl[idx.to(transl.device)]))
               for name, (pose, transl) in tables.items()}
        pp.append(float(psnr(img["pert"], img["true"]).mean()))
        pr.append(float(psnr(img["refined"], img["true"]).mean()))
    psnr_pert, psnr_ref = sum(pp) / len(pp), sum(pr) / len(pr)
    net.load_state_dict(refined_sd)

    result = {
        "init_err": d_init, "refined_err": d_ref, "steps": n_steps,
        "loss_floor": loss_floor, "loss_first_epoch": l0, "loss_last_epoch": l1,
        "recovered_fraction": recovered,
        "render_psnr_perturbed": psnr_pert, "render_psnr_refined": psnr_ref,
        "pass": bool(recovered >= 0.5 and (psnr_ref >= psnr_pert + 6.0 or psnr_ref >= 35.0)),
    }
    print(f"[pose-opt] frozen-net: pose err {d_init:.4f} -> {d_ref:.4f} (reported, not gated), "
          f"loss {l0:.4f} -> {l1:.4f} (floor {loss_floor:.4f}, recovered {recovered:.0%}), "
          f"render-vs-true PSNR {psnr_pert:.1f} -> {psnr_ref:.1f} dB ({n_steps} steps)",
          flush=True)
    return result, refined_sd


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
    ap.add_argument("--pose_opt", action="store_true",
                    help="then the frozen-net pose-recovery leg on the stage-1 endpoint")
    ap.add_argument("--pose_lr", type=float, default=2e-2,
                    help="the leg's embedding learning rate (the JAX canonical gate: 1e-2)")
    ap.add_argument("--pose_epochs", type=int, default=40)
    ap.add_argument("--pose_noise", type=float, default=0.3)
    ap.add_argument("--subjects", type=int, default=1,
                    help="N > 1: N copies of the subject through train_multi, each gated")
    args = ap.parse_args(argv)
    if args.subjects > 1 and (args.stage2 or args.pose_opt):
        ap.error("--subjects N > 1 holds stage 1's gates only")
    canonical = args.query >= 512
    if args.gate_psnr is None:
        args.gate_psnr = 41.0 if canonical else 30.0
    if args.gate_avg_psnr is None:
        args.gate_avg_psnr = 41.5 if canonical else 30.0

    from gaussianavatar_torch.train_multi import subject_names

    work = os.path.abspath(args.work)
    data = join(work, "data")
    if args.subjects > 1:
        root = join(work, "multi")
        sources = [data] * args.subjects
        outs = [join(root, n) for n in subject_names(sources)]
        cli, stage1_argv = "gaussianavatar_torch.train_multi", ["--sources", *sources]
    else:
        root = join(work, "stage1")
        outs = [root]
        cli, stage1_argv = "gaussianavatar_torch.train", ["-s", data]
    out1 = outs[0]
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
        "--dataset_type", "synthetic",
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

    def train_to(out, last, log_name, argv, cli="gaussianavatar_torch.train", root=None):
        """Train (or resume) `out` until its save of epoch `last` exists
        (`-m root`, `out` by default: train_multi's root holds a directory
        a subject); each run's wall clock and steps go to <work>/<log_name>."""
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
            sh(["-m", cli, "-m", root or out, *common, *argv,
                "--epochs", str(last), "--save_epoch", str(save_every),
                "--save_epochs", str(save_every - 1), *extra])
            runs.append({"resumed_from_epoch": resume, "from_iteration": start_it,
                         "to_iteration": iteration_at(last), "wall_s": time.time() - t0,
                         "steady_it_per_sec": steady_rate(join(out, "metrics.jsonl"), t0)})
            with open(log, "w") as f:
                json.dump(runs, f, indent=1)
        return runs

    runs = train_to(out1, args.epochs, "train_runs.json", ["--train_stage", "1", *stage1_argv],
                    cli, root)

    def stage1_gates(out, tag):
        """Gates 1 and 2 and the parameter mean on `out`'s saves (evaluations
        cached in curve{tag}.json and avg_eval{tag}.json) -> (its summary,
        its saved epochs, its final PSNR: the larger of the endpoint and
        the parameter mean)."""
        sub = {"gates": {}, "curve": []}
        epochs = saved_epochs(out, args.epochs)
        curve_epochs = sorted({e for e in epochs if (e // save_every) % 2 == 0} | {epochs[-1]})
        curve_path = join(work, f"curve{tag}.json")
        curve_cache = {}
        if os.path.exists(curve_path):
            curve_cache = {c["epoch"]: c for c in json.load(open(curve_path))}

        def evaluate(e):
            if e not in curve_cache:
                sh(["-m", "gaussianavatar_torch.eval", "-m", out, "--epoch", str(e),
                    "--device", args.device])
                p, s = read_psnr(out)
                curve_cache[e] = {"epoch": e, "psnr": p, "ssim": s}
                with open(curve_path, "w") as f:
                    json.dump([curve_cache[k] for k in sorted(curve_cache)], f)
            return curve_cache[e]

        for e in curve_epochs:
            c = evaluate(e)
            sub["curve"].append(c)
            print(f"[curve{tag}] epoch {e}: PSNR {c['psnr']:.2f} SSIM {c['ssim']:.4f}",
                  flush=True)

        final_psnr = sub["curve"][-1]["psnr"]
        sub["gates"]["stage1_psnr"] = {
            "value": final_psnr, "gate": args.gate_psnr, "pass": final_psnr >= args.gate_psnr
        }

        K_AVG = 3
        tail = epochs[-min(K_AVG, len(epochs)):]
        tail_psnrs = [evaluate(e)["psnr"] for e in tail]
        tail_mean = sum(tail_psnrs) / len(tail_psnrs)
        print(f"[tail{tag}] mean PSNR over {tail}: {tail_mean:.2f} "
              f"(spread {max(tail_psnrs) - min(tail_psnrs):.2f} dB)", flush=True)
        sub["gates"]["stage1_tail_mean_psnr"] = {
            "value": tail_mean, "epochs": tail, "psnrs": tail_psnrs,
            "gate": args.gate_avg_psnr, "pass": tail_mean >= args.gate_avg_psnr,
        }

        # the parameter mean of the tail saves: recorded, not gated
        avg_path = join(work, f"avg_eval{tag}.json")
        if len(epochs) >= 2:
            if os.path.exists(avg_path):
                avg = json.load(open(avg_path))
            else:
                avg_epoch = args.epochs + 1
                average_checkpoints(out, tail, avg_epoch)
                sh(["-m", "gaussianavatar_torch.eval", "-m", out, "--epoch", str(avg_epoch),
                    "--device", args.device])
                p, s = read_psnr(out)
                avg = {"epochs": tail, "psnr": p, "ssim": s}
                with open(avg_path, "w") as f:
                    json.dump(avg, f)
            print(f"[swa{tag}] parameter mean of {avg['epochs']}: PSNR {avg['psnr']:.2f} "
                  f"SSIM {avg['ssim']:.4f}", flush=True)
            sub["swa_experiment"] = avg
            final_psnr = max(final_psnr, avg["psnr"])
        return sub, epochs, final_psnr

    if args.subjects > 1:
        summary["subjects"] = []
        for out in outs:
            name = os.path.basename(out)
            sub, _, _ = stage1_gates(out, "_" + name)
            events = [(r["event"], r["value"]) for r in map(json.loads, open(
                join(out, "metrics.jsonl"))) if "event" in r]
            sub.update(name=name, init=dict(events).get("init"),
                       need_bank=dict(events).get("ragged_need_bank"),
                       retunes=[v for e, v in events if e == "ragged_retune"],
                       footprint_adapt=[v for e, v in events if e == "footprint_adapt"])
            summary["subjects"].append(sub)
            summary["gates"].update({f"{name}/{k}": g for k, g in sub["gates"].items()})
        del summary["curve"]
    else:
        sub, epochs, final_psnr = stage1_gates(out1, "")
        summary.update(sub)

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
                               ["-s", data, "--train_stage", "2",
                                "--stage1_out_path", stage1_end])
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

    pose_wall = None
    if args.pose_opt:
        settings = {"epoch": epochs[-1], "pose_lr": args.pose_lr,
                    "pose_epochs": args.pose_epochs, "pose_noise": args.pose_noise}
        pose_path = join(work, "pose_recovery.json")
        kept = json.load(open(pose_path)) if os.path.exists(pose_path) else None
        if kept is None or kept["settings"] != settings:
            t0 = time.time()
            result, _ = pose_recovery(out1, epochs[-1], args.device, args.pose_lr,
                                      args.pose_epochs, args.pose_noise)
            kept = {"settings": settings, "result": result, "wall_s": time.time() - t0}
            with open(pose_path, "w") as f:
                json.dump(kept, f, indent=1)
        summary["gates"]["pose_recovery"] = kept["result"]
        pose_wall = {"steps": kept["result"]["steps"], "wall_s": kept["wall_s"]}

    # over the training runs of this work directory (a resumed campaign has several)
    def wall_of(rs):
        steps = sum(r["to_iteration"] - r["from_iteration"] for r in rs)
        wall_s = sum(r["wall_s"] for r in rs)
        return {"steps": steps, "wall_s": wall_s,
                "wall_it_per_sec": steps / wall_s if wall_s else None, "runs": rs}

    wall = {**wall_of(runs), "card": card_of(args.device)}
    if args.subjects > 1:
        wall.update(subjects=args.subjects, steady_subject_steps_per_sec=[
            None if r["steady_it_per_sec"] is None else r["steady_it_per_sec"] * args.subjects
            for r in runs])
    if stage2_runs:
        wall["stage2"] = wall_of(stage2_runs)
    if pose_wall:
        wall["pose_recovery"] = pose_wall
    with open(join(work, "wall.json"), "w") as f:
        json.dump(wall, f, indent=1)

    summary["pass"] = all(g["pass"] for g in summary["gates"].values())
    with open(join(work, "quality_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0 if summary["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
