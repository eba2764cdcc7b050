"""scripts/torch_quality_gate.py --pose_opt on the CPU, at the sizes of
tests/test_torch_quality_gate.py with --pose_epochs 2: the frozen-net
pose-recovery leg against the JAX leg of scripts/quality_gate.py, read
from its source (its record's keys and its perturbation), and the
freezing itself: after the leg every network parameter and geo_feature
equals the stage-1 save bit for bit, while the pose embeddings moved."""

import ast
import importlib
import json
import os
import sys
import textwrap
from os.path import join
from types import SimpleNamespace

import numpy as np
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_GATE = join(REPO, "scripts", "quality_gate.py")
SMALL = ["c_geom=8", "hsize=16", "bf16_decoder=0", "tile_size=16", "no_lpips"]


def _gate():
    sys.path.insert(0, join(REPO, "scripts"))
    return importlib.import_module("torch_quality_gate")


def _jax_record_keys():
    """The keys of summary["gates"]["pose_recovery"] in the JAX gate."""
    for node in ast.walk(ast.parse(open(JAX_GATE).read())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and "pose_recovery" in ast.unparse(node.targets[0]):
            return {k.value for k in node.value.keys}
    raise AssertionError("no pose_recovery record in scripts/quality_gate.py")


def _jax_noise(true_pose, pose_noise):
    """The JAX gate's perturbation, its own lines run on `true_pose`."""
    lines = open(JAX_GATE).read().splitlines()
    start = next(i for i, line in enumerate(lines) if "rng = np.random.default_rng(0)" in line)
    end = next(i for i, line in enumerate(lines) if "noise[:, :3] = 0" in line)
    scope = {"np": np, "true_pose": true_pose, "args": SimpleNamespace(pose_noise=pose_noise)}
    exec(textwrap.dedent("\n".join(lines[start:end + 1])), scope)
    return scope["noise"]


def _param_names(out1):
    """The parameter names of the network the gate builds for `out1`."""
    from gaussianavatar_torch.config import Config
    from gaussianavatar_torch.engine.setup import setup_avatar

    cfg = Config.load(join(out1, "cfg_args.json"))
    return {name for name, _ in setup_avatar(cfg, device="cpu").net.named_parameters()}


def test_pose_recovery_leg(tmp_path):
    gate = _gate()
    work = str(tmp_path / "qgp")
    argv = ["--work", work, "--epochs", "2", "--image_size", "32", "--n_train", "2",
            "--n_test", "1", "--query", "32", "--inp", "16", "--gate_psnr", "0",
            "--gate_avg_psnr", "0", "--device", "cpu", "--pose_opt", "--pose_epochs", "2"]
    for flag in SMALL:
        argv += ["--train_flag", flag]
    rc = gate.main(argv)
    summary = json.load(open(join(work, "quality_summary.json")))
    assert rc == (0 if summary["pass"] else 1)
    rec = summary["gates"]["pose_recovery"]
    assert set(rec) == _jax_record_keys()
    # 2 training frames at B=2: one step per epoch
    assert rec["steps"] == 2 * 1
    assert all(np.isfinite(rec[k]) for k in rec if k != "pass")
    assert rec["pass"] == (rec["recovered_fraction"] >= 0.5 and (
        rec["render_psnr_refined"] >= rec["render_psnr_perturbed"] + 6.0
        or rec["render_psnr_refined"] >= 35.0))
    assert json.load(open(join(work, "wall.json")))["pose_recovery"]["steps"] == 2
    # kept beside its settings: a second run refines nothing again
    kept = json.load(open(join(work, "pose_recovery.json")))
    assert gate.main(argv) == rc
    assert json.load(open(join(work, "pose_recovery.json"))) == kept

    # the leg itself: the frozen network stays bit for bit, the poses move
    out1 = join(work, "stage1")
    saved = torch.load(join(out1, "net", "iteration_2", "net_torch.pt"), weights_only=True)
    _, after = gate.pose_recovery(out1, 2, "cpu", pose_epochs=2)
    params = _param_names(out1)
    assert "geo_feature" in params
    for name in params - {"pose_embedding", "transl_embedding"}:
        assert torch.equal(after[name], saved[name]), name
    assert not torch.equal(after["pose_embedding"], saved["pose_embedding"])


def test_pose_noise_is_the_jax_construction():
    gate = _gate()
    true_pose = np.random.default_rng(4).normal(size=(48, 72)).astype(np.float32)
    ours = gate.pose_noise(true_pose.shape, 0.3)
    theirs = _jax_noise(true_pose, 0.3)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    assert (ours[:, :3] == 0).all() and ours[:, 3:].std() > 0.25
