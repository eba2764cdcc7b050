"""Port, stage 2 end to end on the CPU, through the port's CLIs, and file
parity with the JAX package's scripts:

1. the two-stage pipeline on a dataset the port's writer made: `python -m
   gaussianavatar_torch.train` (stage 1) -> `export_stage_1` ->
   `gen_pose_map_frames` -> `train --train_stage 2` -> `eval`,
   `render_novel_pose` and `render_novel_view`, and stage 2 again with
   `--fixed_inp 1` on the port's `gen_pose_map_cano` (mirroring
   tests/test_stage2_e2e.py);
   The stage-2 save converts to the JAX package's net.ckpt
   (scripts/convert_torch_checkpoint_jax.py) with every tree equal;
2. on one JAX stage-1 checkpoint, converted by
   scripts/convert_jax_checkpoint_torch.py, the JAX scripts
   (scripts/export_stage_1.py, scripts/gen_pose_map_frames.py) and the
   port's entry points each write their files into a copy of one dataset:
   `smpl_parms_pred.pth` equal, read by either package's reader, and every
   posmap within 1e-5 with the same coverage;
3. the port's stage-2 eval of a converted JAX stage-2 checkpoint against
   the root eval.py: per frame 0.02 dB PSNR and 2e-4 SSIM (the renders
   differ by the float noise test_torch_eval states), the same
   results.txt keys."""

import importlib
import json
import os
import runpy
import shutil
import sys
from os.path import join

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gaussianavatar_tpu.config import build_parser, extract_config
from gaussianavatar_tpu.data.dataset import load_smpl_parms as j_load_smpl_parms
from gaussianavatar_tpu.data.synthetic_writer import write_synthetic_dataset as j_write
from gaussianavatar_tpu.engine.checkpoint import save_checkpoint
from gaussianavatar_tpu.engine.optim import build_optimizer
from gaussianavatar_tpu.engine.setup import setup_avatar
from gaussianavatar_tpu.engine.train_step import init_state

from gaussianavatar_torch.data.dataset import load_smpl_parms as t_load_smpl_parms

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_TOL, SSIM_TOL = 0.02, 2e-4
# the widths of tests/test_stage2_e2e.py, cut further (hsize, the image)
SMALL_ARGS = ["--dataset_type", "synthetic", "--query_posmap_size", "32",
              "--inp_posmap_size", "32", "--c_geom", "16", "--c_pose", "16", "--nf", "8",
              "--hsize", "16", "--bf16_decoder", "0", "--tile_size", "16"]
# the JAX side's raster settings where it renders: one deep tier, stable sort (F4)
JAX_RASTER = ["--render_max_tiles_per_gaussian", "4", "--render_sort_stable", "1",
              "--tile_capacity", "2048", "--tile_capacity_hi", "0", "--backend", "xla"]


class _TX0:
    def init(self, p):
        return None


def _jax_script(monkeypatch, name, *argv):
    """Run scripts/<name> of the JAX package in this process."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(join(REPO, "scripts", name), run_name="__main__")


def _convert(out):
    sys.path.insert(0, join(REPO, "scripts"))
    importlib.import_module("convert_jax_checkpoint_torch").main(["-m", out])


def _results(out):
    lines = open(join(out, "test_free", "results.txt")).read().splitlines()
    return dict(line.split(": ", 1) for line in lines)


def _port_checkpoint_loads_in_jax(out, epoch):
    """scripts/convert_torch_checkpoint_jax.py on the port's save of
    `epoch`; the JAX load_trained reads it with params, batch_stats, the
    optax moments and counts and the iteration equal to the port's."""
    from gaussianavatar_tpu.config import Config as JConfig
    from gaussianavatar_tpu.engine.inference import load_trained as j_load_trained

    from gaussianavatar_torch import bridge
    from gaussianavatar_torch.engine import checkpoint as tckpt

    sys.path.insert(0, join(REPO, "scripts"))
    importlib.import_module("convert_torch_checkpoint_jax").main(["-m", out, "--epoch",
                                                                  str(epoch)])
    d = tckpt.ckpt_dir(out, epoch)
    net_sd = torch.load(join(d, tckpt.CKPT_NAME), weights_only=True)
    saved = torch.load(join(d, tckpt.TRAIN_NAME), weights_only=True)
    inf = j_load_trained(JConfig.load(join(out, "cfg_args.json")), epoch)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    assert int(inf.state.iteration) == saved["iteration"]
    j_sd = bridge.state_dict_from_jax(to_np(inf.state.params), to_np(inf.state.batch_stats))
    assert j_sd.keys() == net_sd.keys()
    for k, v in net_sd.items():
        assert torch.equal(j_sd[k], v), k
    j_opt = bridge.optimizer_state_from_jax(to_np(inf.state.opt_state))
    assert set(j_opt) == set(saved["optimizer"]) == {"net", "pose_enc"}
    for group, g in saved["optimizer"].items():
        assert int(j_opt[group]["count"]) == int(g["count"]) == saved["iteration"], group
        for kind in ("mu", "nu"):
            assert j_opt[group][kind].keys() == g[kind].keys()
            for name, t in g[kind].items():
                assert torch.equal(j_opt[group][kind][name], t), (group, kind, name)


def test_two_stage_pipeline_through_the_cli(tmp_path, monkeypatch, capsys):
    from gaussianavatar_torch import (
        eval as eval_cli, export_stage_1, gen_pose_map_frames, render_novel_pose,
        render_novel_view, train,
    )
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    data = str(tmp_path / "data")
    out1, out2, out3 = (str(tmp_path / n) for n in ("s1", "s2", "s2_fixed"))
    write_synthetic_dataset(data, n_train=4, n_test=2, image_size=32, device="cpu")
    cpu = ["--device", "cpu"]
    train.main(["-s", data, "-m", out1, "--epochs", "2", "--save_epochs", "0",
                "--no_lpips"] + SMALL_ARGS + cpu)
    s1 = join(out1, "net", "iteration_2")
    export_stage_1.main(["-m", out1, "-s", data] + cpu)
    for split in ("train", "test"):
        assert os.path.exists(join(data, split, "smpl_parms_pred.pth"))
    gen_pose_map_frames.main(["--source_path", data, "--synthetic", "--size", "32"] + cpu)
    for split, n in (("train", 4), ("test", 2)):
        assert sorted(os.listdir(join(data, split, "inp_map"))) == [
            f"inp_posemap_32_{i:08d}.npz" for i in range(n)]

    stage2 = ["--train_stage", "2", "--stage1_out_path", s1, "--save_epochs", "0",
              "--no_lpips"] + SMALL_ARGS + cpu
    train.main(["-s", data, "-m", out2, "--epochs", "3"] + stage2)
    printed = capsys.readouterr().out
    assert f"stage 2 boots from {s1}" in printed and "Training complete" in printed
    records = [json.loads(line) for line in open(join(out2, "metrics.jsonl"))]
    steps = [r for r in records if "step" in r]
    # 2-step groups within 8 steps of the start: each logged (the JAX loop's
    # cadence at 8 steps a dispatch)
    assert [r["step"] for r in steps] == [2, 4, 6]
    assert {"l1", "ssim", "offset", "pose", "total"} <= set(steps[0])
    assert "geo" not in steps[0] and "scale" not in steps[0]
    assert np.isfinite(steps[0]["total"]) and steps[0]["pose"] > 0
    saved = torch.load(join(out2, "net", "iteration_3", "train_torch.pt"), weights_only=True)
    assert saved["iteration"] == 6 and set(saved["optimizer"]) == {"net", "pose_enc"}
    sd1 = torch.load(join(s1, "net_torch.pt"), weights_only=True)
    sd2 = torch.load(join(out2, "net", "iteration_3", "net_torch.pt"), weights_only=True)
    assert any(k.startswith("pose_encoder.") for k in sd2)
    for k in ("geo_feature", "pose_embedding", "transl_embedding"):
        assert torch.equal(sd1[k], sd2[k]), k   # frozen in stage 2
    assert not torch.equal(sd1["pop.decoder.dense.0.weight"], sd2["pop.decoder.dense.0.weight"])

    # the stage-2 save converts to a net.ckpt the JAX package loads, every tree equal
    _port_checkpoint_loads_in_jax(out2, 3)

    res = eval_cli.main(["-m", out2] + cpu)
    assert res["frames"] == 2 and np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
    assert set(_results(out2)) == {"psnr", "ssim", "lpips", "raster_overflow"}
    render_novel_pose.main(["-m", out2, "--image_size", "32", "--test_folder",
                            join(data, "test")] + cpu)
    render_novel_view.main(["-m", out2, "--frames", "4"] + cpu)
    for d, n in ((join(out2, "novel_pose"), 2), (join(out2, "novel_view", "pose_0"), 4)):
        names = sorted(os.listdir(d))
        assert len(names) == n
        img = np.asarray(Image.open(join(d, names[0])), np.float32) / 255
        assert (img < 0.99).any(-1).mean() > 0.02

    # --fixed_inp 1: one static posmap, the canonical one at the input size
    # (the port's gen_pose_map_cano; tests/test_torch_preprocessing.py holds
    # it against the JAX script)
    from gaussianavatar_torch import gen_pose_map_cano

    gen_pose_map_cano.main(["--source_path", data, "--synthetic", "--project_path",
                            str(tmp_path), "--sizes", "32"] + cpu)
    shutil.rmtree(join(data, "train", "inp_map"))
    shutil.rmtree(join(data, "test", "inp_map"))
    train.main(["-s", data, "-m", out3, "--epochs", "1", "--fixed_inp", "1"] + stage2)
    assert "fixed_inp: every frame takes the canonical posmap" in capsys.readouterr().out
    res = eval_cli.main(["-m", out3] + cpu)
    assert np.isfinite(res["psnr"])


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A JAX stage-1 checkpoint (epoch 1) over a tiny synthetic dataset,
    converted to the port's beside it, and a copy of the dataset for the
    port's files."""
    root = tmp_path_factory.mktemp("s2cli")
    data, out1 = str(root / "data_jax"), str(root / "s1")
    j_write(data, n_train=3, n_test=4, image_size=32)
    common = ["-s", data, "-m", out1, "--test_folder", join(data, "test")]
    cfg = extract_config(build_parser().parse_args(common + SMALL_ARGS + JAX_RASTER))
    cfg.save(join(out1, "cfg_args.json"))
    bundle = setup_avatar(cfg, train=False)
    state = jax.jit(lambda k: init_state(bundle.net, bundle.assets, _TX0(), rng=k,
                                         batch_size=1))(jax.random.PRNGKey(3))
    # the embeddings moved off the dataset's poses, so the export shows them
    params = dict(state.params)
    params["pose_embedding"] = params["pose_embedding"] + 0.05
    params["transl_embedding"] = params["transl_embedding"] - 0.02
    state = state.replace(params=params)
    tx = build_optimizer(state.params, cfg.opt, 1, cfg.model.train_stage)
    save_checkpoint(out1, 1, state.replace(opt_state=tx.init(state.params)))
    _convert(out1)
    port_data = str(root / "data_port")
    shutil.copytree(data, port_data)
    return {"root": root, "data": data, "port_data": port_data, "out1": out1}


def test_export_and_posmaps_match_jax_scripts(jax_model, monkeypatch):
    from gaussianavatar_torch import export_stage_1, gen_pose_map_frames

    m = jax_model
    _jax_script(monkeypatch, "export_stage_1.py", "-m", m["out1"], "-s", m["data"],
                "--epoch", "1")
    export_stage_1.main(["-m", m["out1"], "-s", m["port_data"], "--epoch", "1",
                         "--device", "cpu"])
    for split in ("train", "test"):
        jp, tp = (join(d, split, "smpl_parms_pred.pth") for d in (m["data"], m["port_data"]))
        for read in (j_load_smpl_parms, t_load_smpl_parms):
            a, b = read(jp), read(tp)
            assert a.keys() == b.keys() == {"beta", "body_pose", "trans"}
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (split, k)
    pred = t_load_smpl_parms(join(m["port_data"], "train", "smpl_parms_pred.pth"))
    orig = t_load_smpl_parms(join(m["port_data"], "train", "smpl_parms.pth"))
    assert np.allclose(pred["body_pose"], orig["body_pose"] + 0.05, atol=1e-6)

    _jax_script(monkeypatch, "gen_pose_map_frames.py", "--source_path", m["data"],
                "--synthetic", "--size", "32")
    gen_pose_map_frames.main(["--source_path", m["port_data"], "--synthetic", "--size", "32",
                              "--device", "cpu"])
    for split, n in (("train", 3), ("test", 4)):
        names = sorted(os.listdir(join(m["data"], split, "inp_map")))
        assert names == sorted(os.listdir(join(m["port_data"], split, "inp_map")))
        assert len(names) == n
        for name in names:
            with np.load(join(m["data"], split, "inp_map", name)) as f:
                jm = f["posmap32"]
            with np.load(join(m["port_data"], split, "inp_map", name)) as f:
                tm = f["posmap32"]
            assert tm.shape == jm.shape == (32, 32, 3) and tm.dtype == jm.dtype == np.float32
            np.testing.assert_array_equal((tm != 0).any(-1), (jm != 0).any(-1),
                                          err_msg=f"coverage of {split}/{name}")
            assert (jm != 0).any(-1).mean() > 0.2
            np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5, err_msg=f"{split}/{name}")


def test_stage2_eval_matches_jax(jax_model, monkeypatch):
    """A JAX stage-2 checkpoint (the pose encoder fresh, the rest a seeded
    init) over the JAX scripts' files, converted; the port's eval against
    the root eval.py, frame by frame."""
    from gaussianavatar_torch import eval as t_eval

    m = jax_model
    data, out2 = m["data"], str(m["root"] / "s2")
    if not os.path.exists(join(data, "train", "inp_map")):
        _jax_script(monkeypatch, "export_stage_1.py", "-m", m["out1"], "-s", data, "--epoch", "1")
        _jax_script(monkeypatch, "gen_pose_map_frames.py", "--source_path", data,
                    "--synthetic", "--size", "32")
    common = ["-s", data, "-m", out2, "--test_folder", join(data, "test"), "--train_stage", "2",
              "--stage1_out_path", join(m["out1"], "net", "iteration_1")]
    cfg = extract_config(build_parser().parse_args(common + SMALL_ARGS + JAX_RASTER))
    cfg.save(join(out2, "cfg_args.json"))
    bundle = setup_avatar(cfg, train=False)
    state = jax.jit(lambda k: init_state(bundle.net, bundle.assets, _TX0(), rng=k,
                                         batch_size=1))(jax.random.PRNGKey(5))
    tx = build_optimizer(state.params, cfg.opt, 1, 2)
    save_checkpoint(out2, 1, state.replace(opt_state=tx.init(state.params)))
    _convert(out2)
    assert any(k.startswith("pose_encoder.") for k in
               torch.load(join(out2, "net", "iteration_1", "net_torch.pt"), weights_only=True))

    jssim = importlib.import_module("gaussianavatar_tpu.ops.ssim")
    frames = {"psnr": [], "ssim": []}
    j_psnr, j_ssim = jssim.psnr, jssim.ssim

    def rec_psnr(*a, **kw):
        v = j_psnr(*a, **kw)
        frames["psnr"].append(float(v[0, 0]))
        return v

    def rec_ssim(*a, **kw):
        v = j_ssim(*a, **kw)
        frames["ssim"].append(float(v))
        return v

    monkeypatch.setattr(jssim, "psnr", rec_psnr)
    monkeypatch.setattr(jssim, "ssim", rec_ssim)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    importlib.import_module("eval").main(["-m", out2])
    theirs = _results(out2)
    monkeypatch.undo()

    res = t_eval.main(["-m", out2, "--device", "cpu"])
    ours = _results(out2)
    assert set(ours) == set(theirs) == {"psnr", "ssim", "lpips", "raster_overflow"}
    assert int(ours["raster_overflow"]) == int(theirs["raster_overflow"])
    assert res["frames"] == len(frames["psnr"]) == 4
    np.testing.assert_allclose(res["frame_psnr"], frames["psnr"], rtol=0, atol=PSNR_TOL)
    np.testing.assert_allclose(res["frame_ssim"], frames["ssim"], rtol=0, atol=SSIM_TOL)
    assert abs(float(ours["psnr"]) - float(theirs["psnr"])) <= PSNR_TOL
