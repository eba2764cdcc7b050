"""Port, LPIPS through the users' entry points on the CPU, beside the JAX
package (the wiring tests/test_lpips_e2e.py checks there):

  - `python -m gaussianavatar_torch.train` with random weights of the exact
    layout under `<project>/assets/lpips` and `--lpips_start_iter 0`: the
    `lpips` event reads "active" and `vgg` is logged, finite, at every
    logged step; without weights the event is the JAX package's inactive
    string; with `--no_lpips` it is "disabled (--no_lpips)";
  - the port's eval of a converted JAX checkpoint against the root eval.py
    with the same weights: the `lpips:` line of results.txt within 1e-4
    and per frame (the renders differ by the float noise
    tests/test_torch_eval.py states).
"""

import importlib
import json
import os
import sys
from os.path import join

import jax
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.ops import lpips as jl

from test_torch_lpips import random_weights
from test_torch_train_cli import SMALL_ARGS

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LPIPS_TOL = 1e-4


def _project(root, with_weights):
    proj = join(str(root), "proj")
    os.makedirs(join(proj, "assets", "lpips"), exist_ok=True)
    if with_weights:
        np.savez(join(proj, "assets", "lpips", "lpips_alex.npz"), **random_weights(7))
    return proj


def _events(out):
    records = [json.loads(line) for line in open(join(out, "metrics.jsonl"))]
    return {r["event"]: r["value"] for r in records if "event" in r}, \
        [r for r in records if "step" in r]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    root = tmp_path_factory.mktemp("lpipscli")
    write_synthetic_dataset(str(root / "data"), n_train=4, n_test=2, image_size=48,
                            device="cpu")
    return str(root / "data")


def test_train_with_weights_is_active(data, tmp_path, capsys):
    from gaussianavatar_torch import train

    proj, out = _project(tmp_path, True), str(tmp_path / "out")
    train.main(["-s", data, "-m", out, "--device", "cpu", "--project_path", proj,
                "--epochs", "2", "--save_epochs", "0", "--lpips_start_iter", "0"] + SMALL_ARGS)
    assert "LPIPS weights not found" not in capsys.readouterr().out
    events, steps = _events(out)
    assert events["lpips"] == "active"
    assert steps and all("vgg" in r and np.isfinite(r["vgg"]) and r["vgg"] > 0 for r in steps)
    # the debug dumps of the groups (2 steps each) ending within 8 steps of
    # the start, the JAX loop's rule at 8 steps a dispatch
    assert sorted(os.listdir(join(out, "log"))) == [
        "00002_gt.png", "00002_pred.png", "00004_gt.png", "00004_pred.png",
        "pred_00002.ply", "pred_00004.ply"]


@pytest.mark.parametrize("how", ["no_weights", "no_lpips"])
def test_train_without_the_term(data, tmp_path, capsys, how):
    from gaussianavatar_torch import train

    proj, out = _project(tmp_path, how == "no_lpips"), str(tmp_path / "out")
    extra = ["--no_lpips"] if how == "no_lpips" else []
    train.main(["-s", data, "-m", out, "--device", "cpu", "--project_path", proj,
                "--epochs", "1", "--save_epochs", "0", "--max_steps", "1"] + extra + SMALL_ARGS)
    printed = capsys.readouterr().out
    events, steps = _events(out)
    if how == "no_weights":
        assert events["lpips"] == jl.lpips_status(proj)
        assert events["lpips"].startswith("inactive (no weights")
        assert "LPIPS weights not found; training without the LPIPS term" in printed
    else:
        assert events["lpips"] == "disabled (--no_lpips)"
    assert steps and all("vgg" not in r for r in steps)


def test_eval_lpips_matches_jax(tmp_path, monkeypatch):
    """One JAX checkpoint (f32 decoder), converted; both evals with the same
    random LPIPS weights under the project."""
    from gaussianavatar_tpu.config import build_parser, extract_config
    from gaussianavatar_tpu.data.synthetic_writer import write_synthetic_dataset as j_write
    from gaussianavatar_tpu.engine.checkpoint import save_checkpoint
    from gaussianavatar_tpu.engine.optim import build_optimizer
    from gaussianavatar_tpu.engine.setup import setup_avatar
    from gaussianavatar_tpu.engine.train_step import init_state

    from gaussianavatar_torch import eval as t_eval

    from test_torch_slice import SMALL_ARGS as SLICE_ARGS

    class _TX0:
        def init(self, p):
            return None

    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    j_write(data, n_train=3, n_test=3, image_size=32)
    proj = _project(tmp_path, True)
    cfg = extract_config(build_parser().parse_args(
        ["-s", data, "-m", out, "--test_folder", join(data, "test")] + SLICE_ARGS))
    cfg.save(join(out, "cfg_args.json"))
    bundle = setup_avatar(cfg, train=False)
    state = init_state(bundle.net, bundle.assets, _TX0(), rng=jax.random.PRNGKey(3), batch_size=1)
    tx = build_optimizer(state.params, cfg.opt, 1, cfg.model.train_stage)
    save_checkpoint(out, 1, state.replace(opt_state=tx.init(state.params)))
    sys.path.insert(0, join(REPO, "scripts"))
    importlib.import_module("convert_jax_checkpoint_torch").main(["-m", out])

    jax_frames = []
    real = jl.try_load_lpips

    def recording(project_path):
        fn = real(project_path)

        def rec(a, b):
            v = fn(a, b)
            jax_frames.append(float(v))
            return v
        return rec

    monkeypatch.setattr(jl, "try_load_lpips", recording)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    importlib.import_module("eval").main(["-m", out, "--project_path", proj])
    monkeypatch.undo()
    lines = open(join(out, "test_free", "results.txt")).read().splitlines()
    theirs = dict(line.split(": ", 1) for line in lines)

    res = t_eval.main(["-m", out, "--project_path", proj, "--device", "cpu"])
    lines = open(join(out, "test_free", "results.txt")).read().splitlines()
    ours = dict(line.split(": ", 1) for line in lines)
    assert set(ours) == set(theirs) == {"psnr", "ssim", "lpips", "raster_overflow"}
    assert len(res["frame_lpips"]) == len(jax_frames) == 3
    assert float(theirs["lpips"]) > 0
    np.testing.assert_allclose(res["frame_lpips"], jax_frames, rtol=0, atol=LPIPS_TOL)
    assert abs(float(ours["lpips"]) - float(theirs["lpips"])) <= LPIPS_TOL
    assert res["lpips"] == pytest.approx(float(ours["lpips"]), abs=1e-6)
