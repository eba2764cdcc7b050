"""Port parity, the rest of the stage-1 render path: the test split, the eval
CLI and the novel-view CLI, against the JAX package on one JAX checkpoint
(a seeded JAX AvatarNet, f32 decoder, at the small widths of
test_torch_slice), converted once by scripts/convert_jax_checkpoint_torch.py.

Both sides pose the gaussians with float32 LBS summed in different orders,
so the renders agree as test_torch_slice states (at most 0.5% of pixel
values differ by more than 1e-4, none by more than 0.25). Per frame that
bounds PSNR to 0.02 dB and SSIM to 2e-4 here."""

import importlib
import os
import sys
from os.path import join

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gaussianavatar_tpu.config import build_parser, extract_config
from gaussianavatar_tpu.data import dataset as jdata
from gaussianavatar_tpu.data.synthetic_writer import write_synthetic_dataset
from gaussianavatar_tpu.engine.checkpoint import save_checkpoint
from gaussianavatar_tpu.engine.optim import build_optimizer
from gaussianavatar_tpu.engine.setup import setup_avatar
from gaussianavatar_tpu.engine.train_step import init_state
from gaussianavatar_tpu.ops import lpips as jlpips

from gaussianavatar_torch import config as tconfig
from gaussianavatar_torch.data import dataset as tdata

from test_torch_slice import SMALL_ARGS, assert_images_close

torch.set_num_threads(2)

# the module, not the function gaussianavatar_tpu.ops re-exports under its name
jssim = importlib.import_module("gaussianavatar_tpu.ops.ssim")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_TOL, SSIM_TOL = 0.02, 2e-4


class _TX0:
    def init(self, p):
        return None


def _root_cli(name):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A JAX model directory (epoch 1) over a tiny synthetic dataset, with
    the port's net_torch.pt converted beside net.ckpt."""
    root = tmp_path_factory.mktemp("eval")
    data, out = str(root / "data"), str(root / "out")
    write_synthetic_dataset(data, n_train=3, n_test=5, image_size=32)
    common = ["-s", data, "-m", out, "--test_folder", join(data, "test")]
    cfg = extract_config(build_parser().parse_args(common + SMALL_ARGS))
    cfg.save(join(out, "cfg_args.json"))
    bundle = setup_avatar(cfg, train=False)
    state = init_state(bundle.net, bundle.assets, _TX0(), rng=jax.random.PRNGKey(3), batch_size=1)
    tx = build_optimizer(state.params, cfg.opt, 1, cfg.model.train_stage)
    save_checkpoint(out, 1, state.replace(opt_state=tx.init(state.params)))
    sys.path.insert(0, join(REPO, "scripts"))
    importlib.import_module("convert_jax_checkpoint_torch").main(["-m", out])
    return {"data": data, "out": out, "cfg": cfg}


def _results(out):
    lines = open(join(out, "test_free", "results.txt")).read().splitlines()
    return dict(line.split(": ", 1) for line in lines)


def test_test_split_matches_jax(model):
    """Every item of MonoDatasetTest: the image (float32, composited onto
    white) to one float32 ulp (the JAX package decodes through its native
    C++ path, which divides by 255 another way), the poses and cameras
    equal."""
    cfg = model["cfg"]
    jds = jdata.MonoDatasetTest(cfg.model)
    tds = tdata.MonoDatasetTest(tconfig.Config.load(join(model["out"], "cfg_args.json")).model)
    assert len(tds) == len(jds) == 5
    for i in range(len(jds)):
        j, t = jds[i], tds[i]
        assert set(t) == set(j)
        assert t["original_image"].dtype == np.float32 and t["original_image"].shape == (3, 32, 32)
        np.testing.assert_allclose(t["original_image"], j["original_image"], rtol=0, atol=6e-8)
        for k in set(j) - {"original_image"}:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{k} of item {i}")


def test_eval_cli_matches_jax(model, monkeypatch):
    out = model["out"]
    jax_frames = {"psnr": [], "ssim": []}
    j_psnr, j_ssim = jssim.psnr, jssim.ssim

    def rec_psnr(*a, **kw):
        v = j_psnr(*a, **kw)
        jax_frames["psnr"].append(float(v[0, 0]))
        return v

    def rec_ssim(*a, **kw):
        v = j_ssim(*a, **kw)
        jax_frames["ssim"].append(float(v))
        return v

    monkeypatch.setattr(jssim, "psnr", rec_psnr)
    monkeypatch.setattr(jssim, "ssim", rec_ssim)
    _root_cli("eval").main(["-m", out])
    theirs = _results(out)
    monkeypatch.undo()

    from gaussianavatar_torch import eval as t_eval

    res = t_eval.main(["-m", out, "--device", "cpu"])
    ours = _results(out)
    assert set(ours) == set(theirs) == {"psnr", "ssim", "lpips", "raster_overflow"}
    # no LPIPS weights: both write the JAX package's status line
    status = jlpips.lpips_status(model["cfg"].model.project_path)
    assert ours["lpips"] == theirs["lpips"] == status
    assert ours["lpips"].startswith("inactive (no weights")
    assert int(ours["raster_overflow"]) == int(theirs["raster_overflow"])
    assert res["frames"] == 5
    np.testing.assert_allclose(res["frame_psnr"], jax_frames["psnr"], rtol=0, atol=PSNR_TOL)
    np.testing.assert_allclose(res["frame_ssim"], jax_frames["ssim"], rtol=0, atol=SSIM_TOL)
    assert abs(float(ours["psnr"]) - float(theirs["psnr"])) <= PSNR_TOL
    assert abs(float(ours["ssim"]) - float(theirs["ssim"])) <= SSIM_TOL
    names = sorted(os.listdir(join(out, "test_free", "renders")))
    assert names == [f"{i:04d}.png" for i in range(5)]
    assert sorted(os.listdir(join(out, "test_free", "gt"))) == names


def test_rotate_extrinsics_matches_jax():
    """The orbit camera, with and without a center, on both axes the
    datasets use, against the JAX package's (cv2.Rodrigues there)."""
    rng = np.random.default_rng(0)
    E = np.eye(4)
    E[:3, :3] = jdata._rotate_extrinsics(np.eye(4), 0.7, None, "x")[:3, :3]
    E[:3, 3] = rng.normal(size=3)
    for angle in (0.0, 0.3, 2.5, -1.2):
        for axis in ("y", "z"):
            for trans in (None, rng.normal(size=3)):
                np.testing.assert_allclose(tdata._rotate_extrinsics(E, angle, trans, axis),
                                           jdata._rotate_extrinsics(E, angle, trans, axis),
                                           rtol=0, atol=1e-12)


def test_novel_view_cli_matches_jax(model, capsys):
    """4 orbit frames of the fallback pose 0 (the default bullet poses lie
    past the 5 test frames), 8-bit: float noise may flip one level."""
    out = model["out"]
    from gaussianavatar_torch import render_novel_view as t_cli

    t_cli.main(["-m", out, "--frames", "4", "--device", "cpu"])
    assert "falling back to pose 0" in capsys.readouterr().out
    d = join(out, "novel_view", "pose_0")
    names = sorted(os.listdir(d))
    assert names == [f"{i:05d}.png" for i in range(4)]
    ours = {n: np.asarray(Image.open(join(d, n)), np.float32) / 255 for n in names}
    assert all((img < 0.99).any(-1).mean() > 0.02 for img in ours.values())

    _root_cli("render_novel_view").main(["-m", out, "--frames", "4"])
    for n in names:
        theirs = np.asarray(Image.open(join(d, n)), np.float32) / 255
        assert_images_close(np.where(np.abs(ours[n] - theirs) <= 1 / 255 + 1e-6, theirs, ours[n]),
                            theirs)
