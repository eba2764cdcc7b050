"""Port parity, the 3DGS PLY export: gaussianavatar_torch/engine/export.py
against gaussianavatar_tpu/engine/export.py, and `python -m
gaussianavatar_torch.export_avatar_ply` against scripts/export_avatar_ply.py
on one converted JAX checkpoint (f32 decoder).

  - the round trip of tests/test_export.py through the port's writer and
    reader (means to 1e-6, colours to 1e-5, scales to 1e-4 relative,
    opacities to 1e-4, rotations to 1e-6);
  - the writer's bytes equal the JAX writer's for the same arrays, and each
    package reads the other's file;
  - the export of a stage-1 checkpoint at a training frame and at a pose of
    an external smpl_parms file, and of a stage-2 checkpoint (decoded with
    no pose feature map, as the JAX script does): the same vertex count and
    header, every field within 1e-5 (float32 LBS and decoder sums in
    another order; the opacity logit and the rotations exact).
"""

import importlib
import os
import runpy
import shutil
import sys
from os.path import join

import jax
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.engine import export as jexport

from gaussianavatar_torch.engine import export as texport

from test_torch_slice import SMALL_ARGS

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_gaussians(n=100, seed=0):
    rng = np.random.default_rng(seed)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32),
            rng.uniform(1e-3, 0.1, size=(n, 3)).astype(np.float32),
            rng.uniform(0.1, 0.99, size=(n,)).astype(np.float32), rots)


def test_3dgs_ply_roundtrip(tmp_path):
    means, colors, scales, opac, rots = _random_gaussians()
    path = str(tmp_path / "g.ply")
    texport.export_gaussians_ply(path, means, colors, scales, opac, rots)
    head = open(path, "rb").read(800).decode("ascii", errors="ignore")
    for prop in ("f_dc_0", "opacity", "scale_0", "rot_3"):
        assert f"property float {prop}" in head
    back = texport.load_gaussians_ply(path)
    np.testing.assert_allclose(back["means"], means, atol=1e-6)
    np.testing.assert_allclose(back["colors"], colors, atol=1e-5)
    np.testing.assert_allclose(back["scales"], scales, rtol=1e-4)
    np.testing.assert_allclose(back["opacities"], opac, atol=1e-4)
    np.testing.assert_allclose(back["rotations"], rots, atol=1e-6)


def test_writer_bytes_match_jax(tmp_path):
    """The same arrays, the clip and floor cases among them (opacity 0 and
    1, a zero scale)."""
    means, colors, scales, opac, rots = _random_gaussians(57, seed=1)
    opac[:2] = (0.0, 1.0)
    scales[3, 1] = 0.0
    paths = {name: str(tmp_path / f"{name}.ply") for name in ("jax", "torch")}
    jexport.export_gaussians_ply(paths["jax"], means, colors, scales, opac, rots)
    texport.export_gaussians_ply(paths["torch"], means, colors, scales, opac, rots)
    assert open(paths["jax"], "rb").read() == open(paths["torch"], "rb").read()
    for reader, other in ((texport, "jax"), (jexport, "torch")):
        a, b = reader.load_gaussians_ply(paths[other]), jexport.load_gaussians_ply(paths["jax"])
        for k in a:
            assert np.array_equal(a[k], b[k]), k


class _TX0:
    def init(self, p):
        return None


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A JAX stage-1 and a JAX stage-2 checkpoint (seeded inits, epoch 1)
    over one tiny synthetic dataset, each converted to the port's."""
    from gaussianavatar_tpu.config import build_parser, extract_config
    from gaussianavatar_tpu.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_tpu.engine.checkpoint import save_checkpoint
    from gaussianavatar_tpu.engine.optim import build_optimizer
    from gaussianavatar_tpu.engine.setup import setup_avatar
    from gaussianavatar_tpu.engine.train_step import init_state

    root = tmp_path_factory.mktemp("export")
    data = str(root / "data")
    write_synthetic_dataset(data, n_train=3, n_test=2, image_size=32)
    for split in ("train", "test"):
        shutil.copy(join(data, split, "smpl_parms.pth"), join(data, split, "smpl_parms_pred.pth"))
    sys.path.insert(0, join(REPO, "scripts"))
    convert = importlib.import_module("convert_jax_checkpoint_torch")
    outs = {}
    for stage in (1, 2):
        out = str(root / f"s{stage}")
        argv = ["-s", data, "-m", out, "--train_stage", str(stage)] + SMALL_ARGS
        if stage == 2:
            argv += ["--stage1_out_path", join(outs[1], "net", "iteration_1")]
        cfg = extract_config(build_parser().parse_args(argv))
        cfg.save(join(out, "cfg_args.json"))
        bundle = setup_avatar(cfg, train=False)
        state = init_state(bundle.net, bundle.assets, _TX0(), rng=jax.random.PRNGKey(stage),
                           batch_size=1)
        params = dict(state.params)
        params["pose_embedding"] = params["pose_embedding"] + 0.05
        state = state.replace(params=params)
        tx = build_optimizer(state.params, cfg.opt, 1, cfg.model.train_stage)
        save_checkpoint(out, 1, state.replace(opt_state=tx.init(state.params)))
        convert.main(["-m", out])
        outs[stage] = out
    return {"data": data, "s1": outs[1], "s2": outs[2]}


def _ply_fields(path):
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        body = f.read()
    names = [l.split()[-1] for l in header.decode().splitlines()
             if l.startswith("property float")]
    return header, np.frombuffer(body, dtype=[(n, "<f4") for n in names])


@pytest.mark.parametrize("case", ["stage1_frame", "stage1_pose_file", "stage2"])
def test_export_avatar_ply_matches_jax(models, tmp_path, monkeypatch, case):
    from gaussianavatar_torch import export_avatar_ply

    out = models["s2" if case == "stage2" else "s1"]
    extra = ["--frame", "2"]
    if case == "stage1_pose_file":
        extra = ["--pose_file", join(models["data"], "test", "smpl_parms.pth"), "--pose_idx", "1"]
    paths = {name: str(tmp_path / f"{name}.ply") for name in ("jax", "torch")}
    monkeypatch.setattr(sys, "argv", ["export_avatar_ply.py", "-m", out, *extra,
                                      "--out", paths["jax"]])
    runpy.run_path(join(REPO, "scripts", "export_avatar_ply.py"), run_name="__main__")
    monkeypatch.undo()
    export_avatar_ply.main(["-m", out, *extra, "--out", paths["torch"], "--device", "cpu"])

    (jh, ja), (th, ta) = _ply_fields(paths["jax"]), _ply_fields(paths["torch"])
    assert th == jh and len(ta) == len(ja) > 100
    for name in ja.dtype.names:
        assert np.isfinite(ta[name]).all(), name
        if name == "opacity" or name.startswith("rot_"):
            assert np.array_equal(ta[name], ja[name]), name
        else:
            np.testing.assert_allclose(ta[name], ja[name], rtol=0, atol=1e-5, err_msg=name)
