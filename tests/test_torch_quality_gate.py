"""scripts/torch_quality_gate.py on the CPU, 2 epochs at small widths with
the gates at 0: it writes its summary, curve and wall files, a second run
over the same work directory trains and evaluates nothing again, and a run
whose final checkpoint is missing resumes from the newest save."""

import importlib
import json
import os
import sys
from os.path import join

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["c_geom=8", "hsize=16", "bf16_decoder=0", "tile_size=16", "no_lpips"]


def test_quality_gate_runs_and_resumes(tmp_path):
    sys.path.insert(0, join(REPO, "scripts"))
    gate = importlib.import_module("torch_quality_gate")
    work = str(tmp_path / "qg")
    argv = ["--work", work, "--epochs", "2", "--image_size", "32", "--n_train", "2",
            "--n_test", "1", "--query", "32", "--inp", "16", "--gate_psnr", "0",
            "--gate_avg_psnr", "0", "--device", "cpu"]
    for flag in SMALL:
        argv += ["--train_flag", flag]
    assert gate.main(argv) == 0
    summary = json.load(open(join(work, "quality_summary.json")))
    assert summary["pass"] and set(summary["gates"]) == {"stage1_psnr", "stage1_tail_mean_psnr"}
    assert summary["gates"]["stage1_tail_mean_psnr"]["epochs"] == [1, 2]
    assert [c["epoch"] for c in json.load(open(join(work, "curve.json")))] == [1, 2]
    assert summary["swa_experiment"]["epochs"] == [1, 2]
    wall = json.load(open(join(work, "wall.json")))
    assert wall["steps"] == 2 and wall["card"] == "cpu" and len(wall["runs"]) == 1
    metrics = open(join(work, "stage1", "metrics.jsonl")).read()

    # everything is there: nothing is trained or evaluated again
    assert gate.main(argv) == 0
    assert open(join(work, "stage1", "metrics.jsonl")).read() == metrics
    assert len(json.load(open(join(work, "wall.json")))["runs"]) == 1

    # the final save lost: training resumes from epoch 1, not from scratch
    for name in os.listdir(join(work, "stage1", "net", "iteration_2")):
        os.remove(join(work, "stage1", "net", "iteration_2", name))
    os.rmdir(join(work, "stage1", "net", "iteration_2"))
    assert gate.main(argv) == 0
    runs = json.load(open(join(work, "wall.json")))["runs"]
    assert len(runs) == 2
    assert runs[1]["resumed_from_epoch"] == 1
    assert (runs[1]["from_iteration"], runs[1]["to_iteration"]) == (1, 2)
    assert os.path.exists(join(work, "stage1", "net", "iteration_2", "train_torch.pt"))


def test_quality_gate_stage2_leg(tmp_path):
    """--stage2 on the CPU: the export, the posmaps at --inp, stage 2 for
    epochs // 2 from the stage-1 endpoint, its eval and its gate against
    the stage-1 final PSNR (the larger of the endpoint and the parameter
    mean) - 1.5 dB off the canonical workload; a second run trains and
    evaluates nothing again."""
    sys.path.insert(0, join(REPO, "scripts"))
    gate = importlib.import_module("torch_quality_gate")
    work = str(tmp_path / "qg2")
    argv = ["--work", work, "--epochs", "2", "--image_size", "32", "--n_train", "2",
            "--n_test", "1", "--query", "32", "--inp", "32", "--gate_psnr", "0",
            "--gate_avg_psnr", "0", "--device", "cpu", "--stage2"]
    for flag in SMALL + ["c_pose=8", "nf=4"]:
        argv += ["--train_flag", flag]
    rc = gate.main(argv)
    summary = json.load(open(join(work, "quality_summary.json")))
    assert rc == (0 if summary["pass"] else 1)
    g = summary["gates"]["stage2_psnr"]
    final = max(summary["curve"][-1]["psnr"], summary["swa_experiment"]["psnr"])
    assert g["stage1_final"] == final and abs(g["gate"] - (final - 1.5)) < 1e-9
    assert g["value"] == summary["stage2"]["psnr"] and summary["stage2"]["epoch"] == 1
    assert os.path.exists(join(work, "data", "train", "smpl_parms_pred.pth"))
    assert os.path.exists(join(work, "data", "train", "inp_map", "inp_posemap_32_00000001.npz"))
    saved = torch.load(join(work, "stage2", "net", "iteration_1", "train_torch.pt"),
                       weights_only=True)
    assert set(saved["optimizer"]) == {"net", "pose_enc"} and saved["iteration"] == 1
    wall = json.load(open(join(work, "wall.json")))
    assert wall["stage2"]["steps"] == 1 and len(wall["stage2"]["runs"]) == 1
    metrics = open(join(work, "stage2", "metrics.jsonl")).read()
    assert gate.main(argv) == rc
    assert open(join(work, "stage2", "metrics.jsonl")).read() == metrics
    assert len(json.load(open(join(work, "wall.json")))["stage2"]["runs"]) == 1
