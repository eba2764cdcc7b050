"""Port, two stage-2 behaviours on the CPU, through the users' entry points
(ROADMAP Queue 3):

  - F10: a resumed stage-2 run (`--checkpoint_epochs` with `--train_stage
    2`) takes pop, geo_feature and the embeddings from stage 1 again, in
    the JAX loop's order; `restore_state` says so in one line, and a fresh
    stage-2 run does not print it;
  - F11: the port's novel view of a `--fixed_inp` stage-2 avatar decodes
    from the fixed posmap (the JAX render_novel_view.py drops it, a
    deliberate divergence): at orbit angle 0 it decodes, and poses, the
    same gaussians as the novel-pose render from the same posmap and the
    same test pose (equal to 1e-6: one decode in eval mode, batches of
    other sizes).

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


def test_fixed_inp_novel_view_decodes_the_fixed_posmap(fixed_avatar, monkeypatch):
    from gaussianavatar_torch import render_novel_pose, render_novel_view, train
    from gaussianavatar_torch.config import Config
    from gaussianavatar_torch.engine import inference

    out = fixed_avatar["out"]
    if not os.path.exists(join(out, "net", "iteration_1", "net_torch.pt")):
        train.main(fixed_avatar["stage2"] + ["--epochs", "1"])
    fix = inference.load_fixed_inp(Config.load(join(out, "cfg_args.json")).model)
    assert fix is not None and fix.shape == (3, 32, 32)

    calls = []
    real_decode, real_posed = inference.decode_batch, inference.posed_gaussians

    def decode(net, assets, batch):
        res = real_decode(net, assets, batch)
        calls.append({"inp": batch.get("inp_pos_map"), "decoded": [x[0] for x in res]})
        return res

    def posed(*a, **kw):
        res = real_posed(*a, **kw)
        calls[-1]["posed"] = [x[0] if x.dim() == 3 else x for x in res[:3]]
        return res

    monkeypatch.setattr(inference, "decode_batch", decode)
    monkeypatch.setattr(inference, "posed_gaussians", posed)
    render_novel_view.main(["-m", out, "--frames", "4"] + CPU)
    view = calls[0]
    calls.clear()
    render_novel_pose.main(["-m", out, "--image_size", "32", "--test_folder",
                            join(fixed_avatar["data"], "test")] + CPU)
    pose = calls[0]
    for c in (view, pose):
        assert c["inp"] is not None
        assert all(torch.equal(m, torch.as_tensor(fix)) for m in c["inp"])
    for name, a, b in zip(("res", "scales", "shs", "world", "colors", "scales3"),
                          view["decoded"] + view["posed"], pose["decoded"] + pose["posed"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)
    assert float(view["decoded"][0].abs().max()) > 0
