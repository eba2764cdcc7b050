"""Port parity, stage 2 (the UNet pose encoder and the per-frame decode),
against the JAX package on the same numpy inputs, f32 decoder on both
sides (F1), at small widths (query 32, input posmap 32, c_geom = c_pose =
8, nf 4, hsize 16, B=2, 32^2 images):

  - the stage-2 `decode` (offsets, scales, colours, pose feature map) in
    training and eval mode, and the BatchNorm statistics it moves;
  - one and three stage-2 train steps against JAX `make_train_step(
    train_stage=2)` with its Pallas tile kernels in interpret mode (as
    test_torch_train): the loss terms, the gradients of the pose encoder
    and the POP decoder, the parameters and BatchNorm statistics after the
    steps, geo_feature and the embeddings untouched;
  - `stage_load` from a port stage-1 save against JAX `stage_load` from
    the same save converted;
  - a stage-2 TrainState with its optax moments carried JAX -> port -> JAX,
    every tree equal;
  - the order of resume and `stage_load` (ROADMAP F10): a resumed stage-2
    run takes the decoder, geo_feature and the embeddings from stage 1
    again, as the JAX loop does.

Both step packages are started from one JAX `init_state`, carried across by
bridge. The tolerances are test_torch_train's (stated where asserted)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.config import OptimizationParams as JOpt
from gaussianavatar_tpu.engine import checkpoint as jckpt
from gaussianavatar_tpu.engine.loop import stage_load as j_stage_load
from gaussianavatar_tpu.engine.optim import build_optimizer as j_build_optimizer
from gaussianavatar_tpu.engine.train_step import init_state, make_train_step as j_make_train_step
from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
from gaussianavatar_tpu.utils.synthetic import synthetic_pose

from gaussianavatar_torch import bridge
from gaussianavatar_torch.config import ModelParams, OptimizationParams
from gaussianavatar_torch.engine import checkpoint as tckpt
from gaussianavatar_torch.engine.loop import restore_state
from gaussianavatar_torch.engine.optim import build_optimizer
from gaussianavatar_torch.engine.train_step import TrainState, make_train_step
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.utils.synthetic import synthetic_body

from test_torch_train import JCFG, TCFG, _TX0, _loose, _record_grads

torch.set_num_threads(2)

H = W = 32
N_FRAMES, B, START_IT, F = 4, 2, 20, 32
NET_KW = dict(num_frames=N_FRAMES, c_geom=8, c_pose=8, inp_posmap_size=F, hsize=16, nf=4,
              train_stage=2)
FROZEN = ("geo_feature", "pose_embedding", "transl_embedding")
to_np = lambda t: jax.tree.map(np.asarray, t)


def _setup():
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    asset_args = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt, np.zeros(J * 3, np.float32),
                  np.zeros(4, np.float32))
    ja = j_build_assets(jm, *asset_args, query_res=32, pad_to=64)
    poses = np.stack([synthetic_pose(jm, t / N_FRAMES) for t in range(N_FRAMES)])
    tm, _ = synthetic_body()
    ta = build_avatar_assets(tm, *asset_args, query_res=32, pad_to=64, device="cpu")
    return jm, ja, tm, ta, J, poses


def _posmaps(rng):
    """Input posmaps (N, 3, F, F): xyz-like values, zero off a UV island."""
    pm = rng.normal(scale=0.4, size=(N_FRAMES, 3, F, F)).astype(np.float32)
    pm[:, :, :, : F // 4] = 0.0
    return pm


@pytest.fixture(scope="module")
def stage2():
    jm, ja, tm, ta, J, poses = _setup()
    jnet = JAvatarNet(pose_dim=J * 3, pose_init=poses, **NET_KW)
    # jitted: XLA compiles the init once rather than op by op
    st0 = jax.jit(lambda key: init_state(jnet, ja, _TX0(), rng=key, batch_size=B))(
        jax.random.PRNGKey(11))
    return dict(jm=jm, ja=ja, tm=tm, ta=ta, J=J, poses=poses, jnet=jnet, st0=st0)


def _port_net(s, st):
    tnet = AvatarNet(pose_dim=s["J"] * 3, device="cpu", **NET_KW)
    tnet.load_state_dict(bridge.state_dict_from_jax(to_np(st.params), to_np(st.batch_stats)))
    return tnet


def _close(t, j, tol, what):
    j = np.asarray(j, np.float32)
    t = t.detach().numpy()
    assert t.shape == j.shape, what
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * max(np.abs(j).max(), 1e-30), err_msg=what)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_decode_matches_jax(stage2, train):
    """offsets, scales, colours and the pose feature map to 1e-5 of each
    one's largest |value| (the same f32 convolutions and matmuls, summed in
    another order); in training mode also the moved BatchNorm statistics,
    1e-5 relative."""
    s = stage2
    pm = _posmaps(np.random.default_rng(1))[:B]
    st0 = s["st0"]
    variables = {"params": st0.params, "batch_stats": st0.batch_stats}

    def run(module, inp):
        return module.decode(s["ja"], B, inp_posmap=inp, train=train)

    mutable = ["batch_stats"] if train else False
    j_out = jax.jit(lambda v, inp: s["jnet"].apply(v, inp, method=run, mutable=mutable))(
        variables, jnp.asarray(pm.transpose(0, 2, 3, 1)))
    j_out, upd = j_out if train else (j_out, None)
    tnet = _port_net(s, st0).train(train)
    with torch.enable_grad():
        t_out = tnet.decode(s["ta"], B, torch.tensor(pm))
    names = ("offsets", "scales", "colours", "pose_featmap")
    for name, t, j in zip(names, t_out, j_out):
        j = np.asarray(j)
        if name == "pose_featmap":
            j = j.transpose(0, 3, 1, 2)
        _close(t, j, 1e-5, f"{name} ({'train' if train else 'eval'})")
    if train:
        moved = bridge.state_dict_from_jax(to_np(st0.params), to_np(upd["batch_stats"]))
        own = tnet.state_dict()
        keys = [k for k in moved if k.endswith(("running_mean", "running_var"))]
        assert any(k.startswith("pose_encoder.") for k in keys)
        for k in keys:
            _close(own[k], moved[k].numpy(), 1e-5, k)


# --------------------------------------------------------------------------
# The stage-2 train step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(stage2):
    s = stage2
    jm, ja, jnet = s["jm"], s["ja"], s["jnet"]
    st0 = s["st0"].replace(iteration=jnp.int32(START_IT))
    opt_cfg = JOpt()
    rng = np.random.default_rng(3)
    bank = rng.integers(0, 256, size=(N_FRAMES, 3, H, W)).astype(np.uint8)
    inp = _posmaps(rng)
    j_inp = jnp.asarray(inp.transpose(0, 2, 3, 1))
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                  np.array([0.0, -0.8, 1.6], np.float32), K, H, W)
    rep = lambda x: np.repeat(np.asarray(x)[None], B, 0)
    batches = [{"pose_idx": rng.choice(N_FRAMES, B, replace=False).astype(np.int32),
                "world_view_transform": rep(cam.world_view_transform),
                "full_proj_transform": rep(cam.full_proj_transform),
                "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)} for _ in range(3)]
    # stage 2: the pose-optimization gate is 0
    gates = (np.float32(opt_cfg.lambda_rgl), np.float32(0.0), np.float32(0.0))

    copy = lambda t: jax.tree.map(lambda x: jnp.array(x), t)
    jbatch = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    common = dict(train_stage=2, gt_bank=jnp.asarray(bank), inp_bank=j_inp)
    rec_step = j_make_train_step(jnet, jm, ja, _record_grads(), opt_cfg, H, W, (1.0, 1.0, 1.0),
                                 JCFG, **common)
    st_rec = copy(st0).replace(opt_state=_record_grads().init(st0.params))
    st_rec, rec_terms, _ = rec_step(st_rec, jbatch(batches[0]), *gates)
    j_grads = to_np(st_rec.opt_state)

    tx = j_build_optimizer(st0.params, opt_cfg, steps_per_epoch=2, train_stage=2)
    st = copy(st0).replace(opt_state=tx.init(st0.params))
    step = j_make_train_step(jnet, jm, ja, tx, opt_cfg, H, W, (1.0, 1.0, 1.0), JCFG, **common)
    j_traj, j_states = [], []
    for b in batches:
        st, terms, _ = step(st, jbatch(b), *gates)
        j_traj.append((bridge.state_dict_from_jax(to_np(st.params), to_np(st.batch_stats)),
                       {k: float(v) for k, v in terms.items()}, int(st.iteration)))
        j_states.append(st)

    tnet = AvatarNet(pose_dim=s["J"] * 3, device="cpu", **NET_KW)
    tstate = bridge.train_state_from_jax(
        tnet, build_optimizer(tnet, OptimizationParams(), steps_per_epoch=2, train_stage=2),
        to_np(st0.params), to_np(st0.batch_stats), st0.iteration)
    t_step = make_train_step(tnet, s["tm"], s["ta"], OptimizationParams(), H, W,
                             (1.0, 1.0, 1.0), TCFG, torch.tensor(bank), train_stage=2,
                             inp_bank=torch.tensor(inp))
    sd0 = {k: v.clone() for k, v in tnet.state_dict().items()}
    t_traj, t_grads = [], None
    for b in batches:
        terms, images = t_step(tstate, b, *(float(g) for g in gates))
        if t_grads is None:
            t_grads = {k: p.grad.clone() for k, p in tnet.named_parameters()
                       if p.grad is not None}
        t_traj.append(({k: v.clone() for k, v in tnet.state_dict().items()},
                       {k: float(v) for k, v in terms.items()}, tstate.iteration))
    grads_sd = bridge.state_dict_from_jax(j_grads, to_np(st0.batch_stats))
    return {"j_traj": j_traj, "t_traj": t_traj, "j_terms1": {k: float(v) for k, v in
                                                             rec_terms.items()},
            "j_grads": grads_sd, "t_grads": t_grads, "images": images, "sd0": sd0,
            "j_states": j_states, "tnet": tnet, "tstate": tstate}


def test_stage2_step_gradients_match_jax(runs):
    """First step: the stage-2 loss terms (l1, ssim, offset, pose, total)
    to 1e-5 relative; the gradients of every trained parameter (the pose
    encoder, the POP decoder) to 2e-4 of each one's largest |gradient|, the
    BatchNorm-absorbed Dense biases against 1e-6 of the whole net's scale;
    no gradient for geo_feature and the embeddings (frozen)."""
    assert runs["images"].shape == (B, 3, H, W) and bool(torch.isfinite(runs["images"]).all())
    t_terms = runs["t_traj"][0][1]
    assert set(t_terms) == set(runs["j_terms1"]) == {"l1", "ssim", "offset", "pose", "total",
                                                     "raster_overflow"}
    for k, v in runs["j_terms1"].items():
        np.testing.assert_allclose(t_terms[k], v, rtol=1e-5, atol=1e-9, err_msg=k)
    assert t_terms["pose"] > 0
    t_grads = runs["t_grads"]
    params = {k for k in runs["j_grads"] if not k.endswith(("running_mean", "running_var"))}
    assert set(t_grads) == params - set(FROZEN)
    assert any(k.startswith("pose_encoder.") for k in t_grads)
    scale = max(float(runs["j_grads"][name].abs().max()) for name in t_grads)
    for name, tg in t_grads.items():
        jg = runs["j_grads"][name].numpy()
        assert np.isfinite(tg.numpy()).all(), name
        tol = 1e-6 * scale if _loose(name) else 2e-4 * np.abs(jg).max()
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=tol, err_msg=name)
    for name in t_grads:
        if name.startswith("pose_encoder."):
            assert np.abs(runs["j_grads"][name].numpy()).max() > 0, name


@pytest.mark.parametrize("n_steps", [1, 3])
def test_stage2_trajectory_matches_jax(runs, n_steps):
    """Parameters, BatchNorm running statistics, loss terms and the
    iteration after 1 and 3 steps, with test_torch_train's bounds: running
    variances 1e-5 relative, the other parameters 1e-4, the BatchNorm-
    absorbed Dense biases 2 x their rate (0.1 x lr_net in stage 2) per step
    (a sign flip), the running means they feed 0.1 x that per step pair;
    geo_feature and the embeddings equal to where they started, on both
    sides."""
    t_sd, t_terms, t_it = runs["t_traj"][n_steps - 1]
    j_sd, j_terms, j_it = runs["j_traj"][n_steps - 1]
    assert t_it == j_it == START_IT + n_steps
    for k, v in j_terms.items():
        np.testing.assert_allclose(t_terms[k], v, rtol=1e-4, atol=1e-9, err_msg=k)
    lr = 0.1 * JOpt().lr_net
    for name, jv in j_sd.items():
        tv, jv = t_sd[name].numpy(), jv.numpy()
        if name in FROZEN:
            assert np.array_equal(tv, runs["sd0"][name].numpy()), name
            assert np.array_equal(jv, runs["sd0"][name].numpy()), name
            continue
        if name.endswith("running_var"):
            tol = 1e-5 * np.abs(jv).max()
        elif name.endswith("running_mean"):
            tol = 1e-5 * np.abs(jv).max() + 0.2 * lr * n_steps * (n_steps - 1)
        elif _loose(name):
            tol = 2 * lr * n_steps
        else:
            tol = 1e-4
        np.testing.assert_allclose(tv, jv, rtol=0, atol=tol, err_msg=f"{name} after {n_steps}")


def test_stage2_optimizer_groups(runs):
    """The stage-2 groups: net (0.1 x lr_net) and pose_enc (lr_net) each
    counted once per step; geo_feature and the embeddings in no group and
    without gradients."""
    opt = runs["tstate"].optimizer
    assert set(opt.groups) == {"net", "pose_enc"}
    assert opt.groups["net"].lr_fn(0) == np.float32(0.1 * JOpt().lr_net)
    assert opt.groups["pose_enc"].lr_fn(0) == np.float32(JOpt().lr_net)
    assert opt.groups["net"].count == opt.groups["pose_enc"].count == 3
    named = dict(runs["tnet"].named_parameters())
    for name in FROZEN:
        assert not named[name].requires_grad and named[name].grad is None
    trained = set(opt.groups["net"].names) | set(opt.groups["pose_enc"].names)
    assert trained == set(named) - set(FROZEN)
    assert all(n.startswith("pose_encoder.") for n in opt.groups["pose_enc"].names)


def test_stage2_train_state_roundtrip(stage2, runs):
    """A JAX stage-2 TrainState after 3 steps (Adam moments in net and
    pose_enc, nothing in the zeroed groups) -> the port -> JAX: every leaf
    of params, batch_stats and the optax state equal."""
    st = runs["j_states"][-1]
    s = stage2
    tnet = AvatarNet(pose_dim=s["J"] * 3, device="cpu", **NET_KW)
    opt = build_optimizer(tnet, OptimizationParams(), steps_per_epoch=2, train_stage=2)
    tstate = bridge.train_state_from_jax(tnet, opt, to_np(st.params), to_np(st.batch_stats),
                                         st.iteration, opt_state=to_np(st.opt_state))
    assert tstate.iteration == START_IT + 3
    sd = opt.state_dict()
    assert set(sd) == {"net", "pose_enc"} and sd["pose_enc"]["count"] == 3
    assert any(float(v.abs().max()) > 0 for v in sd["pose_enc"]["nu"].values())
    tx = j_build_optimizer(st.params, JOpt(), steps_per_epoch=2, train_stage=2)
    template = {"params": to_np(st.params), "batch_stats": to_np(st.batch_stats),
                "opt_state": to_np(tx.init(st.params))}
    back = bridge.jax_trees_from_port(tnet.state_dict(), sd, template)
    for key in ("params", "batch_stats", "opt_state"):
        orig = to_np(getattr(st, key))
        flat_b, tree_b = jax.tree_util.tree_flatten(back[key])
        flat_o, tree_o = jax.tree_util.tree_flatten(orig)
        assert tree_b == tree_o, key
        assert len(flat_o) > 0
        for a, b in zip(flat_b, flat_o):
            assert a.dtype == b.dtype and np.array_equal(a, b), key


# --------------------------------------------------------------------------
# stage_load, and its order after a resume (F10)
# --------------------------------------------------------------------------

def _stage1_save(s, tmp_path):
    """A stage-1 avatar of the same widths, saved by the port and converted
    to a JAX net.ckpt beside it; -> (its directory, its state_dict)."""
    j1 = JAvatarNet(pose_dim=s["J"] * 3, pose_init=s["poses"] + 0.01,
                    **{**NET_KW, "train_stage": 1})
    st1 = jax.jit(lambda key: init_state(j1, s["ja"], _TX0(), rng=key, batch_size=B))(
        jax.random.PRNGKey(12))
    t1 = AvatarNet(pose_dim=s["J"] * 3, device="cpu", **{**NET_KW, "train_stage": 1})
    sd1 = bridge.state_dict_from_jax(to_np(st1.params), to_np(st1.batch_stats))
    # moved BatchNorm statistics, so that copying them shows
    sd1 = {k: v + 0.25 if k.endswith(("running_mean", "running_var")) else v
           for k, v in sd1.items()}
    t1.load_state_dict(sd1)
    model = str(tmp_path / "stage1")
    tckpt.save_checkpoint(model, 7, t1)
    trees = bridge.jax_trees_from_port(t1.state_dict(), None, {
        "params": to_np(st1.params), "batch_stats": to_np(st1.batch_stats), "opt_state": {}})
    jckpt.save_checkpoint(model, 7, st1.replace(
        params=jax.tree.map(jnp.asarray, trees["params"]),
        batch_stats=jax.tree.map(jnp.asarray, trees["batch_stats"]), opt_state={}))
    return tckpt.ckpt_dir(model, 7), t1.state_dict()


def test_stage_load_matches_jax(stage2, tmp_path):
    """From one stage-1 save: the port's stage_load and the JAX one leave
    equal networks (pop's parameters and BatchNorm statistics, geo_feature
    and the embeddings from stage 1; the pose encoder as it was)."""
    s = stage2
    path, sd1 = _stage1_save(s, tmp_path)
    st2 = j_stage_load(s["st0"], path)
    j_sd = bridge.state_dict_from_jax(to_np(st2.params), to_np(st2.batch_stats))
    tnet = _port_net(s, s["st0"])
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    tckpt.stage_load(tnet, path)
    t_sd = tnet.state_dict()
    assert t_sd.keys() == j_sd.keys()
    for k, v in t_sd.items():
        assert torch.equal(v, j_sd[k]), k
        if k.startswith("pose_encoder."):
            assert torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, sd1[k]), k


def test_resume_then_stage_load_order(stage2, tmp_path):
    """ROADMAP F10, pinned: restore_state resumes a stage-2 save (network,
    optimizer, iteration) and then stage_loads stage 1, as the JAX loop
    does, so pop, geo_feature and the embeddings are stage 1's again while
    the pose encoder and the optimizer state stay the resumed ones."""
    s = stage2
    path, sd1 = _stage1_save(s, tmp_path)
    model = str(tmp_path / "stage2")
    t2 = _port_net(s, s["st0"])
    opt2 = build_optimizer(t2, OptimizationParams(), steps_per_epoch=2, train_stage=2)
    with torch.no_grad():
        for p in t2.parameters():
            p.add_(0.5)
    for p in opt2.groups["net"].mu + opt2.groups["pose_enc"].mu:
        p.fill_(0.125)
    saved = TrainState(t2, opt2, 40)
    tckpt.save_train_state(model, 5, saved)

    t3 = _port_net(s, s["st0"])
    state = TrainState(t3, build_optimizer(t3, OptimizationParams(), 2, train_stage=2))
    mp = ModelParams(model_path=model, train_stage=2, stage1_out_path=path)
    assert restore_state(state, mp, [5]) == 5
    assert state.iteration == 40
    for k, v in t3.state_dict().items():
        expect = t2.state_dict()[k] if k.startswith("pose_encoder.") else sd1[k]
        assert torch.equal(v, expect), k
    assert all(bool((m == 0.125).all()) for m in state.optimizer.groups["pose_enc"].mu)
