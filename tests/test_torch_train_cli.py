"""Port, stage-1 training end to end on the CPU: the port's synthetic writer
against the JAX one, then `python -m gaussianavatar_torch.train --device
cpu` on a tiny dataset the port wrote (the loss must fall within 30 steps)
and `python -m gaussianavatar_torch.render_novel_pose --device cpu` on the
checkpoint it leaves."""

import json
import os
from os.path import join

import numpy as np
import torch

from gaussianavatar_torch.data.dataset import load_smpl_parms

torch.set_num_threads(2)

SMALL_ARGS = ["--dataset_type", "synthetic", "--query_posmap_size", "32",
              "--inp_posmap_size", "16", "--c_geom", "8", "--hsize", "16",
              "--bf16_decoder", "0", "--tile_size", "16"]


def test_synthetic_writer_matches_jax(tmp_path):
    """The same layout, cameras and poses; the frames rendered by the two
    rasterizers, 8-bit: at most 1% of the pixel values differ by more than
    one level (an ulp of LBS can move a tile rect or depth key, as in
    test_torch_slice), none by more than 0.25; the masks likewise."""
    from PIL import Image

    from gaussianavatar_tpu.data.synthetic_writer import write_synthetic_dataset as j_write

    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset as t_write

    j_write(str(tmp_path / "jax"), n_train=2, n_test=1, image_size=48)
    t_write(str(tmp_path / "torch"), n_train=2, n_test=1, image_size=48, device="cpu")
    for split in ("train", "test"):
        j, t = tmp_path / "jax" / split, tmp_path / "torch" / split
        for kind in ("images", "masks"):
            names = sorted(os.listdir(j / kind))
            assert names == sorted(os.listdir(t / kind))
            for n in names:
                a = np.asarray(Image.open(t / kind / n), np.float64) / 255
                b = np.asarray(Image.open(j / kind / n), np.float64) / 255
                d = np.abs(a - b)
                assert d.max() <= 0.25 and (d > 1.5 / 255).mean() <= 0.01, (kind, n)
                if kind == "images":
                    assert (a < 0.99).mean() > 0.05  # the body is in the frame
        for key in ("extrinsic", "intrinsic"):
            np.testing.assert_array_equal(np.load(t / "cam_parms.npz")[key],
                                          np.load(j / "cam_parms.npz")[key])
        tp, jp = (load_smpl_parms(str(d / "smpl_parms.pth")) for d in (t, j))
        assert tp.keys() == jp.keys()
        for key in tp:
            np.testing.assert_allclose(tp[key], jp[key], rtol=0, atol=1e-6, err_msg=key)


def test_train_cli_then_render(tmp_path, capsys):
    from PIL import Image

    from gaussianavatar_torch import render_novel_pose, train
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    write_synthetic_dataset(data, n_train=4, n_test=3, image_size=48, device="cpu")
    train.main(["-s", data, "-m", out, "--train_stage", "1", "--device", "cpu",
                "--max_steps", "30", "--pose_op_start_iter", "0", "--save_epochs", "5",
                "--save_epoch", "10"] + SMALL_ARGS)
    printed = capsys.readouterr().out
    assert "ignores the TPU-only raster knobs" in printed and "Training complete" in printed
    records = [json.loads(line) for line in open(join(out, "metrics.jsonl"))]
    events = {r["event"]: r["value"] for r in records if "event" in r}
    # no LPIPS weights under the project: the JAX package's inactive string
    from gaussianavatar_tpu.ops.lpips import lpips_status

    assert events["lpips"] == lpips_status(os.getcwd())
    assert events["lpips"].startswith("inactive (no weights")
    losses = {r["step"]: r["total"] for r in records if "step" in r}
    # the JAX loop's cadence at the default 8 steps a dispatch: 2-step
    # epochs are groups of 2, logged within 8 of the start and where the
    # step ends within 8 past a multiple of 10
    assert sorted(losses) == [2, 4, 6, 8, 10, 12, 14, 16, 20, 22, 24, 26, 30]
    assert all(np.isfinite(v) for v in losses.values())
    assert losses[30] < 0.8 * losses[2], losses
    # 2 steps per epoch: saved at epoch 10 (a save epoch past 5) and at the end
    assert sorted(os.listdir(join(out, "net"))) == ["iteration_10", "iteration_15"]

    render_novel_pose.main(["-m", out, "--image_size", "48", "--device", "cpu",
                            "--test_folder", join(data, "test")])
    names = sorted(os.listdir(join(out, "novel_pose")))
    assert names == [f"{i:05d}.png" for i in range(3)]
    img = np.asarray(Image.open(join(out, "novel_pose", names[0])), np.float32) / 255
    assert img.shape == (48, 48, 3) and (img < 0.99).any(-1).mean() > 0.02


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    """Every flag of the JAX train.py is ported (--dp since the scale-out
    slice, tests/test_torch_multi_cli.py; --pos_encoding 1 and
    --profile_dir: tests/test_torch_train_options.py). What the port
    refuses is what the JAX CLI refuses: a --dp that does not divide the
    batch, alone or beside other flags, with the JAX CLI's message and
    before any rank starts."""
    import pytest

    from gaussianavatar_torch import train

    base = ["-s", str(tmp_path), "-m", str(tmp_path / "out"), "--device", "cpu"]
    for extra in (["--dp", "3"], ["--dp", "4", "--pos_encoding", "1"],
                  ["--dp", "3", "--profile_dir", str(tmp_path)],
                  ["--train_stage", "2", "--dp", "4", "--checkpoint_epochs", "10"]):
        with pytest.raises(ValueError, match=r"--batch_size \(2\) must be a multiple of --dp"):
            train.main(base + extra)
    assert not os.path.exists(tmp_path / "out")
