"""The first steps of the port's canonical stage-1 campaign from one
checkout, under extra training flags (an initialisation, a footprint, the
need table), to compare early training regimes (ROADMAP F12, F19, F20).
Card by default.

    python3 scripts/torch_init_probe.py --work output/init_probe \
        [--tree DIR] [--max_steps 96] [--flag=--init=flax] [--flag=--max_tiles_per_gaussian=4 ...]

It writes scripts/torch_quality_gate.py's subject (48 + 8 frames of
512^2) under `<work>/data` unless there, then trains `--tree`'s port (a
checkout of the repository, this one by default) through its
`gaussianavatar_torch.train.main` in this process with the campaign's
settings (query 512, input 128, B=2, `--epochs 200`, saves every 25) for
`--max_steps` steps. Keep `--epochs` at the campaign's 200: the loss
terms' schedules follow it, and a run of 4 or 25 epochs trains in another
regime whatever the initialisation. `--flag` adds a training flag the
tree's CLI takes (`--flag=--init=flax`, `--flag=--bf16_decoder=0`). The
last line is one JSON record: the total loss, the scale term and the
raster overflow (the (gaussian, tile) pairs the footprint cap M clipped
and the need table's row caps left out) at every logged step.
"""

import argparse
import json
import os
import shutil
import sys
from os.path import join

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=join(REPO, "output", "init_probe"))
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--max_steps", type=int, default=96)
    ap.add_argument("--flag", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    from gaussianavatar_torch import train
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    data = join(args.work, "data")
    if not os.path.exists(join(data, "train", "smpl_parms.pth")):
        write_synthetic_dataset(data, n_train=48, n_test=8, image_size=512,
                                body_kwargs={"n_rings": 48, "n_cols": 32}, device=args.device)
    flags = [x for f in args.flag for x in f.split("=", 1)]
    name = "_".join([os.path.basename(os.path.abspath(args.tree))]
                    + [f.lstrip("-") for f in flags])
    out = join(args.work, name)
    shutil.rmtree(out, ignore_errors=True)
    train.main(["-s", data, "-m", out, "--dataset_type", "synthetic",
                "--query_posmap_size", "512", "--inp_posmap_size", "128", "--batch_size", "2",
                "--device", args.device, "--no_lpips", "--epochs", "200", "--save_epoch", "25",
                "--save_epochs", "199", "--max_steps", str(args.max_steps)] + flags)
    steps = {r["step"]: r for r in map(json.loads, open(join(out, "metrics.jsonl")))
             if "step" in r}
    print(json.dumps({"tree": args.tree, "port": train.__file__,
                      "flags": flags, "steps": {s: {"total": r["total"], "scale": r["scale"],
                                                    "raster_overflow": r["raster_overflow"]}
                                                for s, r in sorted(steps.items())}}))


if __name__ == "__main__":
    main()
