"""Port parity, preparing a subject: the port's entry points against the JAX
package's scripts on the same inputs, on the CPU.

  - `python -m gaussianavatar_torch.gen_pose_map_cano` against
    scripts/gen_pose_map_cano.py on the synthetic body at sizes 32 and 16:
    posmaps to 1e-5, lbs maps to 1e-6, uv masks exact, joint matrices to
    1e-5 (float32 LBS summed in another order), the canonical .obj to
    1e-6 with equal faces; each package reads the other's joint-matrix
    .pth, and the port's asset loader (engine/setup.py) builds the same
    assets from either package's files;
  - `sample_romp2gsavatar` against scripts/sample_romp2gsavatar.py on the
    capture of tests/test_preprocessing_scripts.py: the same tree,
    byte-identical images and masks, equal cameras and parameters, each
    package reading the other's smpl_parms.pth;
  - `render_pred_smpl` against scripts/render_pred_smpl.py on the synthetic
    dataset (the 24 x 16 body keeps every 32 px tile under the JAX
    rasterizer's capacity of 512, so both blend every pair), with the
    dataset's poses and with `--use_pred`: 8-bit PNGs with at most 0.5% of
    the channel values more than one level apart and none more than 64
    (float noise in LBS can move a splat's tile rect or depth order, as in
    tests/test_torch_slice.py).
"""

import os
import runpy
import shutil
import sys
from os.path import join

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianavatar_tpu.data.dataset import load_smpl_parms as j_load_smpl_parms
from gaussianavatar_tpu.data.synthetic_writer import write_synthetic_dataset as j_write
from gaussianavatar_tpu.utils.torch_pth import load_pth

from gaussianavatar_torch.data.dataset import load_smpl_parms as t_load_smpl_parms

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(monkeypatch, name, *argv):
    """Run scripts/<name> of the JAX package in this process."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(join(REPO, "scripts", name), run_name="__main__")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("prep")
    data = str(root / "data")
    j_write(data, n_train=3, n_test=2, image_size=48)
    return root, data


def test_gen_pose_map_cano_matches_jax(dataset, tmp_path, monkeypatch):
    from gaussianavatar_torch import gen_pose_map_cano
    from gaussianavatar_torch.config import ModelParams
    from gaussianavatar_torch.engine.setup import _load_reference_assets
    from gaussianavatar_torch.utils.obj_io import load_obj

    _, src = dataset
    jd, td = str(tmp_path / "jdata"), str(tmp_path / "tdata")
    shutil.copytree(src, jd)
    shutil.copytree(src, td)
    jp, tp = str(tmp_path / "jproj"), str(tmp_path / "tproj")
    sizes = ["--sizes", "32", "16", "--synthetic"]
    _jax_script(monkeypatch, "gen_pose_map_cano.py", "--source_path", jd, "--project_path", jp,
                *sizes)
    gen_pose_map_cano.main(["--source_path", td, "--project_path", tp, "--device", "cpu", *sizes])

    for R in (32, 16):
        for split in ("train", "test"):
            name = f"query_posemap_{R}_cano_smpl.npz"
            with np.load(join(jd, split, name)) as f, np.load(join(td, split, name)) as g:
                assert set(f.files) == set(g.files) == {f"posmap{R}"}
                a, b = f[f"posmap{R}"], g[f"posmap{R}"]
            assert a.shape == b.shape == (R, R, 3) and a.dtype == b.dtype == np.float32
            assert (a != 0).any(-1).mean() > 0.2
            np.testing.assert_array_equal((a != 0).any(-1), (b != 0).any(-1))
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=f"{split} {R}")
        lbs = [np.load(join(p, "assets", f"lbs_map_smpl_{R}.npy")) for p in (jp, tp)]
        assert lbs[0].shape == lbs[1].shape and lbs[0].dtype == lbs[1].dtype
        np.testing.assert_allclose(lbs[1], lbs[0], rtol=0, atol=1e-6)
        masks = [np.load(join(p, "assets", "uv_masks", f"uv_mask{R}_with_faceid_smpl.npy"))
                 for p in (jp, tp)]
        assert masks[0].dtype == masks[1].dtype and np.array_equal(masks[0], masks[1])

    for split in ("train", "test"):
        jm, tm = (join(d, split, "smpl_cano_joint_mat.pth") for d in (jd, td))
        # each package reads the other's file
        a, b = torch.load(jm, weights_only=True), load_pth(tm)
        assert tuple(a.shape) == b.shape == (5, 4, 4) and b.dtype == np.float32
        np.testing.assert_allclose(b, a.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(torch.load(tm, weights_only=True).numpy(), load_pth(jm),
                                   rtol=0, atol=1e-5)
    ja, ta = load_obj(join(jd, "cano_smpl.obj")), load_obj(join(td, "cano_smpl.obj"))
    np.testing.assert_allclose(ta.verts, ja.verts, rtol=0, atol=1e-6)
    assert np.array_equal(ta.faces_v, ja.faces_v) and len(ta.faces_v) > 0

    # the port's asset loader reads either package's files alike
    betas = np.zeros(4, np.float32)
    assets = []
    for d, p in ((jd, jp), (td, tp)):
        mp = ModelParams(source_path=d, project_path=p, query_posmap_size=32)
        assets.append(_load_reference_assets(mp, betas, 5, "cpu"))
    assert all(a is not None for a in assets)
    assert assets[0].num_valid == assets[1].num_valid > 0
    for x, y in zip(assets[0], assets[1]):
        if torch.is_tensor(x):
            torch.testing.assert_close(y, x, rtol=0, atol=1e-5)


def _romp_capture(root):
    """The capture of tests/test_preprocessing_scripts.py: 10 frames of 24 x
    16, masks, cameras and ROMP poses."""
    romp = root / "romp"
    (romp / "images").mkdir(parents=True)
    (romp / "masks").mkdir()
    N = 10
    rng = np.random.default_rng(0)
    for i in range(N):
        Image.fromarray(
            rng.integers(0, 255, size=(24, 16, 3), dtype=np.uint8)
        ).save(romp / "images" / f"frame_{i:04d}.png")
        Image.fromarray(
            np.full((24, 16), 255, np.uint8)
        ).save(romp / "masks" / f"frame_{i:04d}.png")
    np.savez(romp / "cameras.npz",
             intrinsic=np.array([[20.0, 0, 8], [0, 20.0, 12], [0, 0, 1]]),
             extrinsic=np.eye(4))
    np.savez(romp / "poses_optimized.npz",
             global_orient=rng.normal(size=(N, 3)).astype(np.float32),
             body_pose=rng.normal(size=(N, 69)).astype(np.float32),
             transl=rng.normal(size=(N, 3)).astype(np.float32),
             betas=rng.normal(size=(10,)).astype(np.float32))
    return str(romp)


def _tree(d):
    return sorted(os.path.relpath(join(r, n), d) for r, _, ns in os.walk(d) for n in ns)


def test_sample_romp2gsavatar_matches_jax(tmp_path, monkeypatch):
    from gaussianavatar_torch import sample_romp2gsavatar

    romp = _romp_capture(tmp_path)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    _jax_script(monkeypatch, "sample_romp2gsavatar.py", "--input", romp, "--output", jd)
    sample_romp2gsavatar.main(["--input", romp, "--output", td])
    assert _tree(td) == _tree(jd)
    assert len(os.listdir(join(td, "train", "images"))) == 8
    assert len(os.listdir(join(td, "test", "images"))) == 2
    for rel in _tree(jd):
        if rel.endswith(".png"):
            assert open(join(td, rel), "rb").read() == open(join(jd, rel), "rb").read(), rel
    for split in ("train", "test"):
        with np.load(join(jd, split, "cam_parms.npz")) as a, \
                np.load(join(td, split, "cam_parms.npz")) as b:
            for k in ("intrinsic", "extrinsic"):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        jp, tp = (join(d, split, "smpl_parms.pth") for d in (jd, td))
        for read in (j_load_smpl_parms, t_load_smpl_parms):
            a, b = read(jp), read(tp)
            assert a.keys() == b.keys() == {"beta", "body_pose", "trans"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.float32 and np.array_equal(a[k], b[k]), k
        assert t_load_smpl_parms(tp)["body_pose"].shape[1] == 72


def _pngs(d):
    names = sorted(os.listdir(d))
    return names, {n: np.asarray(Image.open(join(d, n)), np.float64) for n in names}


@pytest.mark.parametrize("use_pred", [False, True], ids=["parms", "pred"])
def test_render_pred_smpl_matches_jax(dataset, monkeypatch, use_pred):
    from gaussianavatar_torch import render_pred_smpl

    root, data = dataset
    extra = []
    if use_pred:
        parms = t_load_smpl_parms(join(data, "train", "smpl_parms.pth"))
        parms["body_pose"] = parms["body_pose"] + 0.1
        torch.save({k: torch.as_tensor(v) for k, v in parms.items()},
                   join(data, "train", "smpl_parms_pred.pth"))
        extra = ["--use_pred"]
    jo, to = str(root / f"jqa_{use_pred}"), str(root / f"tqa_{use_pred}")
    args = ["--source_path", data, "--synthetic", "--n_frames", "3", *extra]
    _jax_script(monkeypatch, "render_pred_smpl.py", *args, "--out", jo)
    render_pred_smpl.main([*args, "--out", to, "--device", "cpu"])
    names, theirs = _pngs(jo)
    assert names == [f"{i:05d}.png" for i in range(3)]
    assert _pngs(to)[0] == names
    ours = _pngs(to)[1]
    for n in names:
        d = np.abs(ours[n] - theirs[n])
        assert d.max() <= 64 and (d > 1).mean() <= 0.005, (n, d.max(), (d > 1).mean())
        # the overlay is there: the body is blended over part of the photo
        photo = np.asarray(Image.open(join(data, "train", "images", f"{int(n[:5]):08d}.png")),
                           np.float64)
        assert (np.abs(ours[n] - photo) > 8).any(-1).mean() > 0.02
