"""Run a cell on several seeds and print, beside each run's own numbers
and verdict, the readings its limits are set from, each judged against
the committed limits (harness/control.py): the control, the planted
half-batch fault and, for the look, the reference in bfloat16 and the
reference under the program's need caps. One process, at the cell's own
sizes, on the card:

    python3 benchmark/tools/readings.py --workload s1-train --seconds 2 --seeds 11 12 13

One JSON line per seed on standard output, and with --out a copy in that
file. --f32 runs the program with its decoder in float32 (a witness for
the look: its semantics against the reference's at the cell's size).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--variants", nargs="*", default=None)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from benchmark import run as bench
    from benchmark.harness import control

    _, _, cfg, mix, limits = bench.cell_spec(args.workload)
    if args.f32:
        cfg = dict(cfg, bf16_decoder=0)
    train = mix["kind"] == "train"
    fn = control.train_readings if train else control.render_readings
    variants = args.variants if args.variants is not None else (
        control.TRAIN if train else control.RENDER)
    for seed in args.seeds:
        t0 = time.time()
        res, run = bench.run_cell(args.workload, seed, args.seconds, False,
                                  overrides=(cfg, mix, limits))
        numbers = {k: v for k, v in run.numbers.items() if not k.startswith("_") or
                   k in ("_losses", "_grad_leaf", "_change_leaf", "_maes", "_scale")}
        line = {"workload": args.workload, "seed": seed, "f32": args.f32,
                "program": {"numbers": numbers, "correct": res["correct"],
                            "check": res["check"]},
                "readings": fn(run, mix, limits, "cuda", variants),
                "s": round(time.time() - t0, 1)}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
