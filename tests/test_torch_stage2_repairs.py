"""Port, two stage-2 behaviours on the CPU, through the users' entry points
(ROADMAP Queue 3):

  - F10: a resumed stage-2 run (`--checkpoint_epochs` with `--train_stage
    2`) takes pop, geo_feature and the embeddings from stage 1 again, in
    the JAX loop's order; `restore_state` says so in one line, and a fresh
    stage-2 run does not print it;
  - F11: the port's novel view of a `--fixed_inp` stage-2 avatar decodes
    with no pose feature map, as the JAX render_novel_view.py does (it
    never loads the fixed posmap), and says so in one line: its orbit's
    decode equals the JAX package's decode of the same checkpoint
    (converted by scripts/convert_torch_checkpoint_jax.py) with no input
    posmap, in eval mode, to tests/test_torch_decoder.py's float32 bound.

The avatar: stage 1 on a dataset the port's writer made, `export_stage_1`,
the port's `gen_pose_map_cano` for the fixed posmap, then stage 2 with
`--fixed_inp 1`.
"""

import os
from os.path import join

import numpy as np
import pytest
import torch

from test_torch_stage2_cli import SMALL_ARGS

torch.set_num_threads(2)

CPU = ["--device", "cpu"]
F10_LINE = "pop, geo_feature and the embeddings come from stage 1 again"
F32_ATOL = 1e-5   # tests/test_torch_decoder.py's float32 bound


@pytest.fixture(scope="module")
def fixed_avatar(tmp_path_factory):
    from gaussianavatar_torch import export_stage_1, gen_pose_map_cano, train
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    root = tmp_path_factory.mktemp("repairs")
    data, out1, out2 = (str(root / n) for n in ("data", "s1", "s2"))
    write_synthetic_dataset(data, n_train=4, n_test=2, image_size=32, device="cpu")
    train.main(["-s", data, "-m", out1, "--epochs", "1", "--save_epochs", "0",
                "--no_lpips"] + SMALL_ARGS + CPU)
    export_stage_1.main(["-m", out1, "-s", data] + CPU)
    gen_pose_map_cano.main(["--source_path", data, "--synthetic", "--sizes", "32",
                            "--project_path", str(root)] + CPU)
    stage2 = ["-s", data, "-m", out2, "--train_stage", "2", "--stage1_out_path",
              join(out1, "net", "iteration_1"), "--fixed_inp", "1", "--save_epochs", "0",
              "--no_lpips"] + SMALL_ARGS + CPU
    return {"data": data, "out": out2, "stage2": stage2}


def test_resumed_stage2_warns_of_stage_load(fixed_avatar, capsys):
    from gaussianavatar_torch import train

    capsys.readouterr()
    train.main(fixed_avatar["stage2"] + ["--epochs", "1"])
    assert F10_LINE not in capsys.readouterr().out
    train.main(fixed_avatar["stage2"] + ["--epochs", "2", "--checkpoint_epochs", "1"])
    printed = capsys.readouterr().out
    assert "resumed from epoch 1" in printed
    lines = [line for line in printed.splitlines() if F10_LINE in line]
    assert len(lines) == 1 and lines[0].startswith("warning: resuming stage 2 from epoch 1")
    # the order is the JAX loop's: the warning, then stage_load
    assert printed.index(lines[0]) < printed.index("stage 2 boots from")


def test_fixed_inp_novel_view_decodes_as_jax(fixed_avatar, monkeypatch, capsys):
    import importlib
    import sys

    import jax

    from gaussianavatar_tpu.config import Config as JConfig
    from gaussianavatar_tpu.engine.inference import load_trained as j_load_trained

    from gaussianavatar_torch import render_novel_view, train
    from gaussianavatar_torch.engine import inference

    out = fixed_avatar["out"]
    if not os.path.exists(join(out, "net", "iteration_1", "net_torch.pt")):
        train.main(fixed_avatar["stage2"] + ["--epochs", "1"])

    calls = []
    real_decode = inference.decode_batch

    def decode(net, assets, batch):
        res = real_decode(net, assets, batch)
        calls.append({"inp": batch.get("inp_pos_map"), "decoded": [x[0] for x in res],
                      "nv": assets.num_valid})
        return res

    monkeypatch.setattr(inference, "decode_batch", decode)
    capsys.readouterr()
    # epoch 1: the F10 test may have resumed the avatar to epoch 2
    render_novel_view.main(["-m", out, "--frames", "4", "--epoch", "1"] + CPU)
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("warning:")]
    assert len(lines) == 1 and "no pose feature map" in lines[0]
    assert calls and all(c["inp"] is None for c in calls)

    sys.path.insert(0, join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "scripts"))
    importlib.import_module("convert_torch_checkpoint_jax").main(["-m", out, "--epoch", "1"])
    inf = j_load_trained(JConfig.load(join(out, "cfg_args.json")), 1)
    variables = {"params": inf.state.params, "batch_stats": inf.state.batch_stats}
    res_j = inf.bundle.net.apply(
        variables, method=lambda m: m.decode(inf.bundle.assets, 1, None, train=False))[:3]
    nv = calls[0]["nv"]
    # offsets are x0.02, so their tolerance scales with it
    for name, a, b, atol in zip(("res", "scales", "shs"), calls[0]["decoded"], res_j,
                                (0.02 * F32_ATOL, F32_ATOL, F32_ATOL)):
        np.testing.assert_allclose(a[:nv].numpy(), np.asarray(jax.device_get(b))[0, :nv],
                                   rtol=0, atol=atol, err_msg=name)
    assert float(calls[0]["decoded"][0][:nv].abs().max()) > 0
