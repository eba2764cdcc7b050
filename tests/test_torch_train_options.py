"""The port's training CLI with the options the JAX train.py has beside the
plain run, on the CPU at small widths: `--pos_encoding 1 --use_aiap` trains
(the AIAP term finite at every logged step, the decoder as wide as the
encoding makes it, its save read by the JAX package through
scripts/convert_torch_checkpoint_jax.py), and `--profile_dir` writes a
Chrome trace of the run with its `train::*` ranges and stops at
`--max_steps`."""

import json
import os
from os.path import join

import numpy as np
import pytest
import torch

from test_torch_train_cli import SMALL_ARGS

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    path = str(tmp_path_factory.mktemp("opts") / "data")
    write_synthetic_dataset(path, n_train=4, n_test=1, image_size=48, device="cpu")
    return path


def _metrics(out):
    records = [json.loads(line) for line in open(join(out, "metrics.jsonl"))]
    return {r["step"]: r for r in records if "step" in r}


def test_pos_encoding_and_aiap_train(data, tmp_path, capsys):
    from gaussianavatar_torch import train
    from gaussianavatar_torch.engine.checkpoint import CKPT_NAME, ckpt_dir

    out = str(tmp_path / "out")
    train.main(["-s", data, "-m", out, "--train_stage", "1", "--device", "cpu",
                "--max_steps", "20", "--pose_op_start_iter", "0", "--pos_encoding", "1",
                "--use_aiap"] + SMALL_ARGS)
    printed = capsys.readouterr().out
    assert "AIAP regularizer on:" in printed and "k=5" in printed
    steps = _metrics(out)
    assert sorted(steps) == [1, 10, 20]
    assert all(np.isfinite(r["aiap"]) and r["aiap"] > 0 and np.isfinite(r["total"])
               for r in steps.values())
    assert steps[20]["total"] < steps[1]["total"]
    cfg = json.load(open(join(out, "cfg_args.json")))["net"]
    assert (cfg["pos_encoding"], cfg["num_emb_freqs"], cfg["posemb_incl_input"]) == (1, 6, 0)
    sd = torch.load(join(ckpt_dir(out, 10), CKPT_NAME), weights_only=True)
    # c_geom 8 + the uv encoded with 6 frequencies: 2 x 12
    assert sd["pop.decoder.dense.0.weight"].shape[1] == 8 + 24

    # the save converts to the JAX package's, which builds the same
    # encoded decoder from cfg_args.json and reads every tree equal
    import importlib
    import sys

    import jax

    from gaussianavatar_tpu.config import Config as JConfig
    from gaussianavatar_tpu.engine.inference import load_trained as j_load_trained

    from gaussianavatar_torch import bridge

    sys.path.insert(0, join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "scripts"))
    importlib.import_module("convert_torch_checkpoint_jax").main(["-m", out])
    inf = j_load_trained(JConfig.load(join(out, "cfg_args.json")), 10)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    j_sd = bridge.state_dict_from_jax(to_np(inf.state.params), to_np(inf.state.batch_stats))
    assert j_sd.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(j_sd[k], v), k


def test_profile_dir_writes_a_trace(data, tmp_path, capsys):
    from gaussianavatar_torch import train

    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    train.main(["-s", data, "-m", out, "--train_stage", "1", "--device", "cpu",
                "--max_steps", "3", "--profile_dir", prof] + SMALL_ARGS)
    printed = capsys.readouterr().out
    trace = join(prof, "trace.json")
    assert f"profiler trace written to {trace}" in printed
    events = json.load(open(trace))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"train::step", "train::decode", "train::backward", "render::blend"} <= names
    assert sum(e.get("name") == "train::step" for e in events) == 3
    # 2 steps per epoch: the third step ends the run in epoch 2
    assert os.listdir(join(out, "net")) == ["iteration_2"]
    saved = torch.load(join(out, "net", "iteration_2", "train_torch.pt"), weights_only=True)
    assert saved["iteration"] == 3
