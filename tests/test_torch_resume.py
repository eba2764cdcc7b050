"""Port parity, resumable training state:

(b) the port's TrainState (network, optimizer counts and moments,
    iteration) saved and loaded bit-equal, and stepping on identically;
(c) a JAX TrainState after 2 JAX steps, moments and counts included,
    carried into the port by bridge.train_state_from_jax: 2 more steps on
    each side agree within the bounds of test_torch_train's trajectory test;
(d) a port checkpoint converted by scripts/convert_torch_checkpoint_jax.py:
    the JAX package's load_trained reads the `net.ckpt`, and its params,
    batch_stats, optimizer moments and counts and iteration equal the
    port's to float32;
(e) `python -m gaussianavatar_torch.train --checkpoint_epochs E` on the
    CPU: the run goes on from the saved iteration and counts, logs its first
    step, and takes the regulariser weight decayed from E, as the JAX loop.
"""

import importlib
import json
import os
import sys
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.config import OptimizationParams as JOpt
from gaussianavatar_tpu.engine.optim import build_optimizer as j_build_optimizer
from gaussianavatar_tpu.engine.train_step import init_state, make_train_step as j_make_train_step
from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
from gaussianavatar_tpu.utils.synthetic import synthetic_pose

from gaussianavatar_torch import bridge
from gaussianavatar_torch.config import OptimizationParams
from gaussianavatar_torch.engine import checkpoint as tckpt
from gaussianavatar_torch.engine.optim import build_optimizer
from gaussianavatar_torch.engine.train_step import TrainState, make_train_step
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.utils.synthetic import synthetic_body

from test_torch_train import JCFG, TCFG, _loose, _TX0
from test_torch_train_cli import SMALL_ARGS

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_grads(net, rng, zero_embed=False):
    for name, p in net.named_parameters():
        g = torch.tensor(rng.normal(size=tuple(p.shape)).astype(np.float32))
        if name in ("pose_embedding", "transl_embedding"):
            g[torch.tensor(rng.uniform(size=g.shape[0]) < 0.5)] = 0.0
            if zero_embed:
                g.zero_()
        p.grad = g


def _small_net(seed):
    return AvatarNet(3, 15, c_geom=4, inp_posmap_size=8, hsize=8,
                     generator=torch.Generator().manual_seed(seed), device="cpu")


def test_train_state_roundtrip(tmp_path):
    """(b) Everything bit-equal after save + load, the net count and the
    SparseAdam step apart (a step with no embedding row touched), and the
    two states step on to bit-equal parameters."""
    rng = np.random.default_rng(0)
    net = _small_net(0)
    state = TrainState(net, build_optimizer(net, OptimizationParams(), steps_per_epoch=2), 0)
    for i in range(3):
        _random_grads(net, rng, zero_embed=(i == 1))
        state.optimizer.step()
        state.iteration += 1
    tckpt.save_train_state(str(tmp_path), 5, state)
    tckpt.save_checkpoint(str(tmp_path), 7, net)  # a net-only save: no optimizer state

    other = _small_net(1)
    restored = TrainState(other, build_optimizer(other, OptimizationParams(), steps_per_epoch=2))
    tckpt.load_train_state(str(tmp_path), 5, restored)
    assert restored.iteration == 3
    for (k, a), (_, b) in zip(net.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k
    saved, loaded = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert saved["net"]["count"] == loaded["net"]["count"] == 3
    assert int(saved["embed"]["step_count"]) == int(loaded["embed"]["step_count"]) == 2
    for group in saved:
        for kind in ("mu", "nu"):
            assert saved[group][kind].keys() == loaded[group][kind].keys()
            for name, t in saved[group][kind].items():
                assert torch.equal(t, loaded[group][kind][name]), (group, kind, name)
                if group != "embed" or kind == "nu":
                    assert bool((t != 0).any()), (group, kind, name)

    assert tckpt.latest_epoch(str(tmp_path)) == 7
    assert tckpt.latest_epoch(str(tmp_path), tckpt.TRAIN_NAME) == 5
    with pytest.raises(FileNotFoundError, match="no optimizer state"):
        tckpt.load_train_state(str(tmp_path), 7, restored)

    grads = np.random.default_rng(1)
    _random_grads(net, grads)
    _random_grads(other, np.random.default_rng(1))
    state.optimizer.step()
    restored.optimizer.step()
    for (k, a), (_, b) in zip(net.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k


# --------------------------------------------------------------------------
# (c) a JAX TrainState with its moments, carried into the port
# --------------------------------------------------------------------------

H = W = 32
N_FRAMES, B, START_IT = 4, 2, 20
NET_KW = dict(num_frames=N_FRAMES, c_geom=8, inp_posmap_size=16, hsize=16)


def test_jax_state_with_moments_steps_on_in_port():
    """2 JAX steps, then the state (params, batch_stats, the optax counts
    and moments, the iteration) into the port: the carried optimizer state
    equal to JAX's, then 2 more steps on each side within the bounds of
    test_train_step_trajectory_matches_jax for 2 steps."""
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    asset_args = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt, np.zeros(J * 3, np.float32),
                  np.zeros(4, np.float32))
    ja = j_build_assets(jm, *asset_args, query_res=32, pad_to=64)
    poses = np.stack([synthetic_pose(jm, t / N_FRAMES) for t in range(N_FRAMES)])
    jnet = JAvatarNet(pose_dim=J * 3, pose_init=poses, **NET_KW)
    st = init_state(jnet, ja, _TX0(), rng=jax.random.PRNGKey(7), batch_size=B)
    opt_cfg = JOpt()
    tx = j_build_optimizer(st.params, opt_cfg, steps_per_epoch=2, train_stage=1)
    st = st.replace(opt_state=tx.init(st.params), iteration=jnp.int32(START_IT))

    rng = np.random.default_rng(4)
    bank = rng.integers(0, 256, size=(N_FRAMES, 3, H, W)).astype(np.uint8)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                  np.array([0.0, -0.8, 1.6], np.float32), K, H, W)
    rep = lambda x: np.repeat(np.asarray(x)[None], B, 0)
    batches = [{"pose_idx": rng.choice(N_FRAMES, B, replace=False).astype(np.int32),
                "world_view_transform": rep(cam.world_view_transform),
                "full_proj_transform": rep(cam.full_proj_transform),
                "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)} for _ in range(4)]
    gates = (np.float32(opt_cfg.lambda_rgl), np.float32(1.0), np.float32(0.0))
    step = j_make_train_step(jnet, jm, ja, tx, opt_cfg, H, W, (1.0, 1.0, 1.0), JCFG,
                             gt_bank=jnp.asarray(bank))
    jbatch = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    for b in batches[:2]:
        st, _, _ = step(st, jbatch(b), *gates)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    mid = {"params": to_np(st.params), "batch_stats": to_np(st.batch_stats),
           "opt_state": to_np(st.opt_state), "iteration": int(st.iteration)}
    for b in batches[2:]:
        st, j_terms, _ = step(st, jbatch(b), *gates)
    j_sd = bridge.state_dict_from_jax(to_np(st.params), to_np(st.batch_stats))
    j_terms = {k: float(v) for k, v in j_terms.items()}

    tm, _ = synthetic_body()
    ta = build_avatar_assets(tm, *asset_args, query_res=32, pad_to=64, device="cpu")
    tnet = AvatarNet(pose_dim=J * 3, device="cpu", **NET_KW)
    tstate = bridge.train_state_from_jax(
        tnet, build_optimizer(tnet, OptimizationParams(), steps_per_epoch=2),
        mid["params"], mid["batch_stats"], mid["iteration"], opt_state=mid["opt_state"])
    assert tstate.iteration == START_IT + 2
    carried = tstate.optimizer.state_dict()
    expect = bridge.optimizer_state_from_jax(mid["opt_state"])
    assert carried["net"]["count"] == carried["geo"]["count"] == 2
    assert int(carried["embed"]["step_count"]) == 2
    for group in expect:
        for kind in ("mu", "nu"):
            assert carried[group][kind].keys() == expect[group][kind].keys()
            for name, t in expect[group][kind].items():
                assert torch.equal(carried[group][kind][name], t), (group, kind, name)
    assert float(carried["net"]["nu"]["pop.decoder.dense.0.weight"].abs().max()) > 0

    t_step = make_train_step(tnet, tm, ta, OptimizationParams(), H, W, (1.0, 1.0, 1.0), TCFG,
                             torch.tensor(bank))
    for b in batches[2:]:
        t_terms, _ = t_step(tstate, b, *(float(g) for g in gates))
    assert tstate.iteration == int(st.iteration) == START_IT + 4
    for k, v in j_terms.items():
        np.testing.assert_allclose(float(t_terms[k]), v, rtol=1e-4, atol=1e-9, err_msg=k)
    n, lr = 2, JOpt().lr_net
    t_sd = tnet.state_dict()
    for name, jv in j_sd.items():
        tv, jv = t_sd[name].numpy(), jv.numpy()
        if name in ("geo_feature", "pose_embedding", "transl_embedding"):
            tol = 2e-5
        elif name.endswith("running_var"):
            tol = 1e-5 * np.abs(jv).max()
        elif name.endswith("running_mean"):
            tol = 1e-5 * np.abs(jv).max() + 0.2 * lr * n * (n - 1)
        elif _loose(name):
            tol = 2 * lr * n
        else:
            tol = 1e-4
        np.testing.assert_allclose(tv, jv, rtol=0, atol=tol, err_msg=name)


# --------------------------------------------------------------------------
# (d), (e) through the CLIs on a tiny dataset
# --------------------------------------------------------------------------

def _metrics(out):
    return [json.loads(line) for line in open(join(out, "metrics.jsonl")) if '"step"' in line]


def test_port_checkpoint_converts_to_jax(tmp_path):
    """(d) 3 port steps, then scripts/convert_torch_checkpoint_jax.py; the
    JAX load_trained reads net.ckpt with every tree equal to the port's."""
    from gaussianavatar_tpu.config import Config as JConfig
    from gaussianavatar_tpu.engine.inference import load_trained as j_load_trained

    from gaussianavatar_torch import train
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    write_synthetic_dataset(data, n_train=4, n_test=1, image_size=32, device="cpu")
    train.main(["-s", data, "-m", out, "--device", "cpu", "--max_steps", "3",
                "--pose_op_start_iter", "0"] + SMALL_ARGS)
    epoch = tckpt.latest_epoch(out, tckpt.TRAIN_NAME)
    d = tckpt.ckpt_dir(out, epoch)
    net_sd = torch.load(join(d, tckpt.CKPT_NAME), weights_only=True)
    saved = torch.load(join(d, tckpt.TRAIN_NAME), weights_only=True)
    assert saved["iteration"] == 3

    sys.path.insert(0, join(REPO, "scripts"))
    importlib.import_module("convert_torch_checkpoint_jax").main(["-m", out])
    assert os.path.exists(join(d, "net.ckpt"))

    cfg = JConfig.load(join(out, "cfg_args.json"))
    inf = j_load_trained(cfg, epoch)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    assert int(inf.state.iteration) == 3
    j_sd = bridge.state_dict_from_jax(to_np(inf.state.params), to_np(inf.state.batch_stats))
    assert j_sd.keys() == net_sd.keys()
    for k, v in net_sd.items():
        assert torch.equal(j_sd[k], v), k
    j_opt = bridge.optimizer_state_from_jax(to_np(inf.state.opt_state))
    for group, g in saved["optimizer"].items():
        count = "step_count" if group == "embed" else "count"
        assert int(j_opt[group][count]) == int(g[count]) == 3, group
        for kind in ("mu", "nu"):
            assert j_opt[group][kind].keys() == g[kind].keys()
            for name, t in g[kind].items():
                assert torch.equal(j_opt[group][kind][name], t), (group, kind, name)


def test_resume_cli_goes_on_from_the_checkpoint(tmp_path):
    """(e) 20 epochs of one step, then one more epoch resumed from
    iteration_20: the first resumed step is 21, logged, with the regulariser
    weight undecayed (the decay counts from the resumed epoch: 0.85 **
    ((21 - 20) // 20) = 1, where an uninterrupted run has 0.85 at epoch
    21); the optimizer counts go on from 20."""
    from gaussianavatar_torch import train
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    write_synthetic_dataset(data, n_train=2, n_test=1, image_size=32, device="cpu")
    base = ["-s", data, "-m", out, "--device", "cpu", "--pose_op_start_iter", "0"] + SMALL_ARGS
    train.main(base + ["--epochs", "20"])
    before = _metrics(out)
    # one-step groups at the default 8 steps a dispatch: the JAX loop logs
    # the first 8 steps and those ending within 8 past a multiple of 10
    assert [r["step"] for r in before] == [1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15,
                                           16, 17, 20]
    assert before[-1]["w_rgl"] == pytest.approx(OptimizationParams().lambda_rgl * 0.85)

    train.main(base + ["--epochs", "21", "--checkpoint_epochs", "20",
                       "--start_checkpoint", "ignored"])
    after = _metrics(out)[len(before):]
    assert [r["step"] for r in after] == [21]
    assert after[0]["w_rgl"] == pytest.approx(OptimizationParams().lambda_rgl)
    assert np.isfinite(after[0]["total"])
    saved = torch.load(join(tckpt.ckpt_dir(out, 21), tckpt.TRAIN_NAME), weights_only=True)
    assert saved["iteration"] == 21
    assert saved["optimizer"]["net"]["count"] == saved["optimizer"]["geo"]["count"] == 21
    assert int(saved["optimizer"]["embed"]["step_count"]) == 21
