"""Time H-fwd and H-bwd of several source trees on the same inputs, on one card.

    python3 scripts/torch_blend_ab.py TREE [TREE ...] [--rounds 2]

Each TREE is a checkout of the repository (a directory holding
`gaussianavatar_torch/`), e.g. the parent and a change unpacked with
`git archive`. This script first records, with the package it sits in, the
blend inputs of chip_smoke.py's two main paths: one render batch (4 poses
of the canonical-width avatar at 1024^2, `chip_smoke.make_slice`) and the
last training step's batch (30 steps, `torch_blend_probe.
record_training_batch`), and saves them. Then, in turns (the trees in the
order given, then reversed, `--rounds` times), a fresh process per tree
builds that tree's kernels and times, through that tree's wrappers, H-fwd on
the render batch and on the training batch and H-bwd on the training batch
(CUDA events over 20 calls after 2 warm-up calls), and checks each against
the first tree's outputs: H-fwd's n_contrib and done exactly, H-bwd's pair
gradients within 1e-5 of each channel's largest |value|. It prints one line
per (tree, round) and a JSON summary of the medians.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record(path):
    import torch

    sys.path.insert(0, REPO)
    from torch_blend_probe import record_render_batch, record_training_batch

    render_fwd = record_render_batch()
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        train_fwd, train_bwd = record_training_batch(work)
    torch.save({"render_fwd": list(render_fwd), "train_fwd": list(train_fwd),
                "train_bwd": list(train_bwd)}, path)


def time_tree(tree, path, ref_path):
    """In this process: the kernels of `tree` on the saved inputs -> dict."""
    import torch

    sys.path.insert(0, tree)
    from gaussianavatar_torch.ops import rasterize_tile as rt

    inputs = torch.load(path)

    def ms(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / 20

    outs = {"render_fwd": rt.blend_tiles(*inputs["render_fwd"]),
            "train_fwd": rt.blend_tiles(*inputs["train_fwd"]),
            "train_bwd": rt.blend_tiles_bwd(*inputs["train_bwd"])}
    if ref_path is None:
        torch.save(outs, path + ".ref")
    else:
        ref = torch.load(ref_path)
        for key in ("render_fwd", "train_fwd"):
            for i in (2, 3):  # n_contrib, done
                if not torch.equal(outs[key][i], ref[key][i]):
                    raise SystemExit(f"{tree}: {key} output {i} differs from the first tree's")
        d = (outs["train_bwd"] - ref["train_bwd"]).abs().amax(0)
        if bool((d > 1e-5 * ref["train_bwd"].abs().amax(0)).any()):
            raise SystemExit(f"{tree}: train_bwd differs from the first tree's")
    return {"render_fwd_ms": ms(lambda: rt.blend_tiles(*inputs["render_fwd"])),
            "train_fwd_ms": ms(lambda: rt.blend_tiles(*inputs["train_fwd"])),
            "train_bwd_ms": ms(lambda: rt.blend_tiles_bwd(*inputs["train_bwd"]))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", nargs=3, metavar=("TREE", "INPUTS", "REF"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        tree, path, ref = args.child
        print(json.dumps(time_tree(os.path.abspath(tree), path, None if ref == "-" else ref)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_blend_ab: needs CUDA", file=sys.stderr)
        return 2
    if not args.trees:
        ap.error("name at least one tree")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    results = {t: [] for t in args.trees}
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        path = os.path.join(work, "inputs.pt")
        record(path)
        turns = [t for _ in range(args.rounds) for t in args.trees + args.trees[::-1]]
        first = args.trees[0]
        for n, tree in enumerate(turns):
            ref = "-" if n == 0 else path + ".ref"
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree, path,
                                  ref], capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                print(res.stdout, res.stderr, file=sys.stderr)
                raise SystemExit(f"timing {tree} failed")
            out = json.loads(res.stdout.strip().splitlines()[-1])
            results[tree].append(out)
            print(f"{tree}: " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
                  + (" (reference outputs)" if n == 0 and tree == first else ""))
    summary = {t: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
               for t, rs in results.items()}
    print(json.dumps({"card": card, "median_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
