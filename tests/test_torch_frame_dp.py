"""Port parity, frame data parallelism (parallel/mesh.py), stage 1 and
stage 2: one train step of dp = 2 gloo ranks on the CPU, each on its half
of a global batch of 4 frames, against the same step unsharded in the
port and against the JAX package's unsharded step (tests/test_frame_dp.py
proves the JAX sharded step equal to that one), all from one JAX
`init_state` carried across by bridge, f32 decoder (F1).

Bounds, the JAX test's for the sharded step against the unsharded one:
loss terms 1e-6, the SGD(1.0) update (the gradient) 1e-5, the BatchNorm
running statistics 1e-5 (relative and absolute). Against the JAX step the
bounds of tests/test_torch_train.py and test_torch_stage2.py (the two
packages pose and blend in float orders of their own): terms 1e-5
relative, gradients 2e-4 of each parameter's largest |gradient| (the
BatchNorm-absorbed Dense biases, whose true gradient is 0, 2e-6 of the
net's scale: the port's float noise, within 1e-6 there, plus the
all-reduce's), running statistics 1e-5 relative.

Stage 1 decodes once per step, alike on every rank, so its BatchNorm
statistics are global without a sync; stage 2's (the UNet over each rank's
frames, the decoder over B x Nv points) are global only through the sync,
and the stage-2 case shows that a step with the sync turned off
(`mesh.syncs_batch_stats` patched to False in the rank) misses the bounds.

The ranks are spawned processes (`mesh.spawn_ranks`, joined with a
timeout), so this module imports JAX only inside the fixture: a rank
imports it to find its worker function."""

import contextlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

from gaussianavatar_torch.engine.train_step import TrainState, make_train_step
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.ops.rasterize import RasterizeConfig
from gaussianavatar_torch.parallel import mesh
from gaussianavatar_torch.utils.synthetic import synthetic_body

torch.set_num_threads(2)

H = W = 32
N_FRAMES = B = 4
DP = 2
START_IT = 20
TCFG = RasterizeConfig(16, 16)
NET_KW = {1: dict(num_frames=N_FRAMES, c_geom=8, inp_posmap_size=16, hsize=16),
          2: dict(num_frames=N_FRAMES, c_geom=8, c_pose=8, inp_posmap_size=32, hsize=16, nf=4,
                  train_stage=2)}
FROZEN = ("geo_feature", "pose_embedding", "transl_embedding")
JOIN_TIMEOUT_S = 240
TOL_LOSS, TOL_GRAD, TOL_BN = 1e-6, 1e-5, 1e-5


class SGD:
    """optax.sgd(1.0) over the trainable parameters: the update is minus
    the (all-reduced) gradient, which `grads` keeps by name (a delta of two
    unit-sized parameters would round it to their ulp)."""

    def __init__(self, net):
        self.named = [(k, p) for k, p in net.named_parameters() if p.requires_grad]
        self.params = [p for _, p in self.named]
        self.grads = {}

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for k, p in self.named:
            if p.grad is not None:
                self.grads[k] = p.grad.clone()
                p.sub_(p.grad)


def _port_step(inputs, sync=True):
    """One SGD(1.0) step of the port from `inputs` (the saved state, banks,
    batch, gates and decoder) on this process's share of the batch (the
    whole batch outside a group) -> (state_dict after, terms, gradients).
    `sync` False: no BatchNorm syncs; "decoder": all but the fused
    decoder's."""
    stage = inputs["stage"]
    tm, uv = synthetic_body()
    J = tm.parents.shape[0]
    ta = build_avatar_assets(tm, uv.verts, uv.uvs, uv.faces_v, uv.faces_vt,
                             np.zeros(J * 3, np.float32), np.zeros(4, np.float32),
                             query_res=32, pad_to=64, device="cpu")
    net = AvatarNet(pose_dim=J * 3, device="cpu", decoder_impl=inputs.get("decoder_impl", "ref"),
                    **inputs.get("net_kw", NET_KW[stage]))
    net.load_state_dict(inputs["sd"])
    if stage == 2:
        for name in FROZEN:
            getattr(net, name).requires_grad_(False)
    state = TrainState(net, SGD(net), START_IT)
    step = make_train_step(net, tm, ta, inputs["opt_cfg"], H, W, (1.0, 1.0, 1.0), TCFG,
                           inputs["bank"], train_stage=stage, inp_bank=inputs["inp_bank"])
    batch = mesh.shard_batch(inputs["batch"], mesh.group())
    if sync is True:
        ctx = contextlib.nullcontext()
    elif sync == "decoder":
        from gaussianavatar_torch.models import decoder

        ctx = mock.patch.object(decoder, "mesh", mock.Mock(
            syncs_batch_stats=lambda: False, global_sum=mesh.global_sum))
    else:
        ctx = mock.patch.object(mesh, "syncs_batch_stats", lambda: False)
    with ctx:
        terms, _ = step(state, batch, *inputs["gates"])
    return ({k: v.clone() for k, v in net.state_dict().items()},
            {k: float(v) for k, v in terms.items()}, state.optimizer.grads)


def _dp_rank(work):
    """A rank's work: the step on its shard, with the BatchNorm sync and (in
    stage 2) without; each rank writes what it got."""
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = {"sync": _port_step(inputs)}
    if inputs["stage"] == 2:
        out["nosync"] = _port_step(inputs, sync=False)
        if inputs.get("decoder_impl") == "fused":
            out["nodecsync"] = _port_step(inputs, sync="decoder")
    torch.save(out, os.path.join(work, f"rank{mesh.group().rank}.pt"))


@pytest.fixture(scope="module", params=[1, 2], ids=["stage1", "stage2"])
def runs(request, tmp_path_factory):
    return make_runs(request.param, tmp_path_factory)


def make_runs(stage, tmp_path_factory, decoder_impl="ref", net_kw=None, ranks=True):
    """The JAX step, the port's unsharded step and (with `ranks`) the dp = 2
    ranks' steps of `stage` from one JAX init_state, both packages on
    `decoder_impl` and NET_KW[stage] updated by `net_kw`."""
    import jax
    import jax.numpy as jnp

    from gaussianavatar_tpu.config import OptimizationParams as JOpt
    from gaussianavatar_tpu.engine.train_step import init_state, make_train_step as j_step
    from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
    from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
    from gaussianavatar_tpu.ops.camera import Camera as JCamera
    from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
    from gaussianavatar_tpu.utils.synthetic import synthetic_pose

    from gaussianavatar_torch import bridge
    from gaussianavatar_torch.config import OptimizationParams

    from test_torch_train import JCFG, _TX0, _record_grads

    to_np = lambda t: jax.tree.map(np.asarray, t)
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    ja = j_build_assets(jm, uv.verts, uv.uvs, uv.faces_v, uv.faces_vt,
                        np.zeros(J * 3, np.float32), np.zeros(4, np.float32),
                        query_res=32, pad_to=64)
    poses = np.stack([synthetic_pose(jm, t / N_FRAMES) for t in range(N_FRAMES)])
    kw = {**NET_KW[stage], **(net_kw or {})}
    jnet = JAvatarNet(pose_dim=J * 3, pose_init=poses, decoder_impl=decoder_impl, **kw)
    st0 = jax.jit(lambda key: init_state(jnet, ja, _TX0(), rng=key, batch_size=B))(
        jax.random.PRNGKey(7 + stage))
    st0 = st0.replace(iteration=jnp.int32(START_IT))
    # the step donates its state: the start as numpy first
    sd0 = bridge.state_dict_from_jax(to_np(st0.params), to_np(st0.batch_stats))
    bs0 = to_np(st0.batch_stats)

    rng = np.random.default_rng(10 + stage)
    bank = rng.integers(0, 256, size=(N_FRAMES, 3, H, W)).astype(np.uint8)
    inp = rng.normal(scale=0.4, size=(N_FRAMES, 3, 32, 32)).astype(np.float32)
    inp[:, :, :, :8] = 0.0
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                  np.array([0.0, -0.8, 1.6], np.float32), K, H, W)
    rep = lambda x: np.repeat(np.asarray(x)[None], B, 0)
    batch = {"pose_idx": rng.permutation(N_FRAMES).astype(np.int32),
             "world_view_transform": rep(cam.world_view_transform),
             "full_proj_transform": rep(cam.full_proj_transform),
             "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)}
    gates = (float(np.float32(JOpt().lambda_rgl)), float(stage == 1), 0.0)

    # the JAX step on the whole batch, its gradients recorded
    extra = dict(train_stage=2, inp_bank=jnp.asarray(inp.transpose(0, 2, 3, 1))) \
        if stage == 2 else {}
    rec = j_step(jnet, jm, ja, _record_grads(), JOpt(), H, W, (1.0, 1.0, 1.0), JCFG,
                 gt_bank=jnp.asarray(bank), **extra)
    st_rec = st0.replace(opt_state=_record_grads().init(st0.params))
    st_rec, j_terms, _ = rec(st_rec, {k: jnp.asarray(v) for k, v in batch.items()},
                             *(np.float32(g) for g in gates))
    j_grads = bridge.state_dict_from_jax(to_np(st_rec.opt_state), bs0)
    j_stats = bridge.state_dict_from_jax(to_np(st_rec.params), to_np(st_rec.batch_stats))

    inputs = {"stage": stage, "sd": sd0, "bank": torch.tensor(bank),
              "inp_bank": torch.tensor(inp) if stage == 2 else None, "batch": batch,
              "gates": gates, "opt_cfg": OptimizationParams(), "decoder_impl": decoder_impl,
              "net_kw": kw}
    work = str(tmp_path_factory.mktemp(f"dp_stage{stage}_{decoder_impl}"))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    full = _port_step(inputs)
    if ranks:
        mesh.spawn_ranks(_dp_rank, DP, "cpu", (work,), timeout_s=JOIN_TIMEOUT_S)
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP)]
    else:
        ranks = []
    return {"stage": stage, "sd0": sd0, "full": full, "ranks": ranks,
            "j_terms": {k: float(v) for k, v in j_terms.items()}, "j_grads": j_grads,
            "j_stats": j_stats}


def _params(sd):
    return {k: v for k, v in sd.items() if not k.endswith(("running_mean", "running_var"))}


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _loose(name):
    """The Dense biases that feed a BatchNorm: true gradient exactly zero."""
    return name.startswith("pop.decoder.dense.") and name.endswith(".bias") and \
        name.split(".")[3] not in ("7", "10", "13")


def test_dp_loss_matches_unsharded(runs):
    """Every logged term of the dp step (the ranks' means, all-reduced) is
    the whole batch's, on every rank: 1e-6 of the unsharded port step, 1e-5
    relative of the JAX step."""
    _, full_terms, _ = runs["full"]
    assert full_terms.keys() == runs["j_terms"].keys()
    for rank in runs["ranks"]:
        _, terms, _ = rank["sync"]
        assert terms.keys() == full_terms.keys()
        for k, v in full_terms.items():
            np.testing.assert_allclose(terms[k], v, rtol=TOL_LOSS, atol=TOL_LOSS, err_msg=k)
            np.testing.assert_allclose(terms[k], runs["j_terms"][k], rtol=1e-5, atol=1e-9,
                                       err_msg=k)


def test_dp_update_matches_unsharded(runs):
    """The SGD(1.0) step: every parameter after it 1e-5 of the unsharded
    step's (the JAX test's bound); every gradient (all-reduced over the
    ranks) 1e-5 of the unsharded step's largest |gradient| of that
    parameter (of the net's, for the BatchNorm-absorbed biases, whose true
    gradient is 0), the same on both ranks, and within test_torch_train's
    bounds of the JAX gradient."""
    sd0 = runs["sd0"]
    full_sd, _, full_g = runs["full"]
    (r0, _, g0), (r1, _, g1) = (rank["sync"] for rank in runs["ranks"])
    trained = set(full_g)
    assert "geo_feature" in trained if runs["stage"] == 1 else \
        any(k.startswith("pose_encoder.") for k in trained) and not trained & set(FROZEN)
    assert set(g0) == set(g1) == trained
    scale = max(float(g.abs().max()) for g in full_g.values())
    j_scale = max(float(runs["j_grads"][k].abs().max()) for k in trained)
    for k in _params(sd0):
        assert torch.equal(r0[k], r1[k]), k
        np.testing.assert_allclose(r0[k].numpy(), full_sd[k].numpy(), rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=k)
    for k, g in full_g.items():
        assert torch.equal(g0[k], g1[k]), k
        ref = scale if _loose(k) else float(g.abs().max())
        np.testing.assert_allclose(g0[k].numpy(), g.numpy(), rtol=0, atol=TOL_GRAD * ref,
                                   err_msg=k)
        jg = runs["j_grads"][k].numpy()
        # the true-zero biases: float noise of two sums, the port's (within
        # 1e-6 of the scale, test_torch_train) and the ranks' all-reduce
        tol = 2e-6 * j_scale if _loose(k) else 2e-4 * np.abs(jg).max()
        np.testing.assert_allclose(g0[k].numpy(), jg, rtol=0, atol=tol, err_msg=k)


def test_dp_batch_stats_match_unsharded(runs):
    """The BatchNorm running statistics after the dp step are the global
    batch's: 1e-5 of the unsharded step's, alike on both ranks, 1e-5
    relative of the JAX step's."""
    full_sd, _, _ = runs["full"]
    stats = _stats(full_sd)
    assert any(k.startswith("pose_encoder.") for k in stats) == (runs["stage"] == 2)
    for rank in runs["ranks"]:
        sd, _, _ = rank["sync"]
        for k, v in stats.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=TOL_BN, atol=TOL_BN,
                                       err_msg=k)
            j = runs["j_stats"][k].numpy()
            np.testing.assert_allclose(sd[k].numpy(), j, rtol=0,
                                       atol=1e-5 * np.abs(j).max(), err_msg=k)


@pytest.mark.parametrize("runs", [2], indirect=True, ids=["stage2"])
def test_stage2_dp_needs_the_batchnorm_sync(runs):
    """Stage 2 with the sync off: each rank normalises with its own frames'
    statistics, so the running statistics (and the update) miss the bounds
    the synced step meets, and the ranks disagree."""
    full_sd, _, full_g = runs["full"]
    (sd0, _, g0), (sd1, _, _) = (rank["nosync"] for rank in runs["ranks"])
    stats = _stats(full_sd)
    missed = [k for k in stats if not np.allclose(sd0[k].numpy(), full_sd[k].numpy(),
                                                  rtol=TOL_BN, atol=TOL_BN)]
    assert any(k.startswith("pose_encoder.") for k in missed), missed
    assert any(k.startswith("pop.decoder.") for k in missed), missed
    missed_g = [k for k, g in full_g.items() if not np.allclose(
        g0[k].numpy(), g.numpy(), rtol=0, atol=TOL_GRAD * float(g.abs().max()))]
    assert any(k.startswith("pose_encoder.") for k in missed_g), missed_g
    assert any(not torch.equal(sd0[k], sd1[k]) for k in stats)


def test_dp_rank_bins_with_the_global_batch_key():
    """A rank renders its share of a batch as the whole batch renders it.
    The depth key has fewer bits the more views a sort holds: with 8 tiles a
    view, 27 for one view, 26 for two. Two half-transparent gaussians over
    one pixel whose depths tie at 26 bits but not at 27, the nearer one
    later in row order: the two-view batch blends them in row order, frame
    0 alone by depth, and frame 0 alone with `key_views=2` (what a dp = 2
    rank passes) exactly as the batch."""
    from gaussianavatar_torch.ops import rasterize_tile as tt
    from gaussianavatar_torch.ops.projection import ProjectedGaussians

    Hs, Ws = 32, 64
    assert tt.depth_key_bits(8) == 27 and tt.depth_key_bits(16) == 26
    base = int(np.array([1.5], np.float32).view(np.int32)[0]) >> 6 << 6
    # far: 26-bit key K, 27-bit key 2K + 1; near: K and 2K
    depths = np.array([base + 32 + 5, base + 3], np.int32).view(np.float32)
    assert depths[1] < depths[0]
    two = lambda a: torch.as_tensor(np.stack([a, a]))
    projs = ProjectedGaussians(
        means2d=two(np.array([[24.0, 8.0], [24.0, 8.0]], np.float32)),
        depths=two(depths),
        conics=two(np.array([[0.25, 0.0, 0.25]] * 2, np.float32)),
        radii=two(np.array([6.0, 6.0], np.float32)))
    colors = two(np.array([[1.0, 0, 0], [0, 0, 1.0]], np.float32))
    opac = torch.full((2, 2), 0.5)
    bg = torch.zeros(3)
    first = lambda: ProjectedGaussians(*(x[:1] for x in projs))

    def render(p, c, o, key_views=0):
        img, _ = tt.rasterize_views_binned(p, c, o, bg, Hs, Ws,
                                           RasterizeConfig(16, 4, key_views=key_views))
        return img

    batch = render(projs, colors, opac)[0]
    alone = render(first(), colors[:1], opac[:1])[0]
    as_rank = render(first(), colors[:1], opac[:1], key_views=2)[0]
    assert not torch.equal(alone, batch)   # the order differs at the pixel
    assert torch.equal(as_rank, batch)
