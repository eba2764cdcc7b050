"""Steady it/s of 30 single training steps (the port's training CLI at
`--steps_per_dispatch 1`, stage 1, canonical widths, 8 synthetic frames of
512^2, B=2) with the fused decoder and with the reference one, for the
checkout this is run from (its working directory), on the card: the
one-step path of two commits compared in one call, in turns.

    for t in parent change change parent; do (cd $t && python3 <this script>); done

Reads it/s from metrics.jsonl between the logged steps 10 and 30 (at one
step a dispatch both commits log steps 1, 10, 20 and 30).
"""

import json
import os
import sys
import tempfile

STEPS = 30


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_step_ab: needs a CUDA device")
    from gaussianavatar_torch import train as train_cli
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.utils.cuda_build import build_all

    build_all()
    tree = os.path.basename(os.getcwd())
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as work:
        data = os.path.join(work, "data")
        write_synthetic_dataset(data, n_train=8, n_test=1, image_size=512, device="cuda")
        for name, extra in (("fused", ["--fused_decoder", "1"]), ("reference", [])):
            out = os.path.join(work, name)
            train_cli.main(["-s", data, "-m", out, "--train_stage", "1", "--dataset_type",
                            "synthetic", "--pose_op_start_iter", "0", "--no_lpips", "--quiet",
                            "--max_steps", str(STEPS), "--steps_per_dispatch", "1"] + extra)
            records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
            t = {r["step"]: r["t"] for r in records if "step" in r}
            print(f"{tree} {name} decoder: {(STEPS - 10) / (t[STEPS] - t[10]):.2f} it/s "
                  f"(steps 10-{STEPS}) on {torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main()
