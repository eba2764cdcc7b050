"""One replayed group against the same group run eagerly, from one saved
training state, on the card: is a CUDA graph of S training steps
(engine/train_step.make_train_steps) the trajectory of S single steps?

Writes 16 synthetic frames of 512^2 (the port's writer), sets up stage 1 at
the canonical widths (query 512, bf16 decoder; with `--f32` the f32 one)
through the port's own setup, runs one group of 8 steps through the
dispatch (eager, then the graph's capture), saves the state (network,
BatchNorm statistics, optimizer moments and counts), then from that state:
the next group replayed, the same group as 8 single steps
(`make_train_step`), replayed again, and eagerly again. Prints, per loss
term, the relative difference at each of the 8 steps of replay against
eager and of eager against eager, the largest of replay against replay,
and the worst final tensors of replay against eager. With
`--deterministic` under `torch.use_deterministic_algorithms` (and
`CUBLAS_WORKSPACE_CONFIG=:4096:8`), where every difference should be 0.

    python3 scripts/torch_replay_check.py [--deterministic] [--f32]
"""

import argparse
import copy
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
TERMS = ("total", "l1", "ssim", "scale", "offset", "geo")


def _snapshot(state):
    """The state's tensors, cloned (network, optimizer groups, iteration)."""
    import torch

    clone = lambda v: (v.clone() if torch.is_tensor(v) else
                       {k: x.clone() for k, x in v.items()} if isinstance(v, dict) else v)
    opt = {g: {k: clone(v) for k, v in o.items()}
           for g, o in state.optimizer.state_dict().items()}
    return ({k: v.clone() for k, v in state.net.state_dict().items()}, copy.deepcopy(opt),
            state.iteration)


def _restore(state, snap):
    """Back to `snap`, in place (a captured graph reads the same tensors)."""
    sd, opt, it = snap
    state.net.load_state_dict(sd)
    state.optimizer.load_state_dict(opt)
    state.iteration = it


def _rel(a, b):
    return ((a - b).abs() / b.abs().clamp_min(1e-12)).cpu()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--f32", action="store_true", help="the f32 decoder")
    args = ap.parse_args()
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_replay_check: needs a CUDA device")
    from gaussianavatar_torch.config import build_parser, extract_config
    from gaussianavatar_torch.data.dataset import BatchLoader
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine import loop, train_step as ts
    from gaussianavatar_torch.engine.optim import build_optimizer
    from gaussianavatar_torch.engine.setup import setup_avatar
    from gaussianavatar_torch.ops.rasterize import raster_config
    from gaussianavatar_torch.utils.cuda_build import build_all

    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    build_all()
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        data = os.path.join(work, "data")
        write_synthetic_dataset(data, n_train=16, n_test=1, image_size=512, device="cuda")
        argv = ["-s", data, "-m", os.path.join(work, "out"), "--dataset_type", "synthetic",
                "--pose_op_start_iter", "0", "--no_lpips"] + ["--bf16_decoder", "0"] * args.f32
        cfg = extract_config(build_parser().parse_known_args(argv)[0])
        bundle = setup_avatar(cfg, device="cuda", train=True)
        gt_bank = loop.build_gt_bank(bundle.frames, "cuda")
        H, W = bundle.frames.image_hw()
        loader = BatchLoader(bundle.frames, cfg.model.batch_size)
        net = bundle.net
        net.train()
        state = ts.TrainState(net, build_optimizer(net, cfg.opt, len(loader), 1))
        step_args = (net, bundle.body_model, bundle.assets, cfg.opt, H, W, (0.0, 0.0, 0.0),
                     raster_config(cfg, train=True), gt_bank)
        steps = ts.make_train_steps(*step_args, steps=8)
        single = ts.make_train_step(*step_args)
        feeds = [{k: v for k, v in b.items() if k not in loop.DROP_KEYS} for b in loader]
        gates = (cfg.opt.lambda_rgl, 1.0, 0.0)
        steps(state, feeds[:8], *gates)            # eager, then the capture
        snap = _snapshot(state)
        group = feeds[:8][::-1]
        replay, _ = steps(state, group, *gates)
        replay_sd = {k: v.clone() for k, v in net.state_dict().items()}
        _restore(state, snap)
        eager = [single(state, f, *gates)[0] for f in group]
        eager_sd = {k: v.clone() for k, v in net.state_dict().items()}
        _restore(state, snap)
        replay2, _ = steps(state, group, *gates)
        _restore(state, snap)
        eager2 = [single(state, f, *gates)[0] for f in group]
    mode = "deterministic" if args.deterministic else "default algorithms"
    print(f"{mode}, {'f32' if args.f32 else 'bf16'} decoder, on {torch.cuda.get_device_name(0)}")
    for k in TERMS:
        e, e2 = (torch.stack([t[k] for t in run]) for run in (eager, eager2))
        print(f"{k}: replay vs eager {[f'{x:.2e}' for x in _rel(replay[k], e).tolist()]}")
        print(f"{k}: eager vs eager {[f'{x:.2e}' for x in _rel(e2, e).tolist()]}")
        print(f"{k}: replay vs replay, largest {float(_rel(replay2[k], replay[k]).max()):.2e}")
    worst = sorted(((float((replay_sd[k].float() - v.float()).norm()
                           / v.float().norm().clamp_min(1e-30)), k)
                    for k, v in eager_sd.items() if v.is_floating_point()), reverse=True)[:4]
    print("final tensors, replay vs eager, worst relative L2:",
          [(k, f"{d:.2e}") for d, k in worst])


if __name__ == "__main__":
    main()
