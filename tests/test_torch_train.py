"""Port parity, stage-1 training: SSIM / PSNR / L1, flax-semantics BatchNorm
in training mode, the optimizer groups, and the train step, each against
the JAX package on the same numpy inputs (f32 decoder on both sides, F1).

The train step starts both packages from one JAX `init_state`, carried
across by bridge.train_state_from_jax (params, batch_stats, iteration), and
runs JAX `make_train_step(jit=True)` with its Pallas tile kernels in
interpret mode (the only JAX blend whose backward has the 0.99 clamp's
straight-through rule) beside the port's step, both with the uint8 GT bank.
The two pose the gaussians with float32 LBS summed in different orders,
so everything downstream differs by float noise; Adam then turns the
exactly-zero gradients of the BatchNorm-absorbed Dense biases into +-lr
flips, so those parameters get a loose bound and the rest tight ones
(stated where they are asserted)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from gaussianavatar_tpu.config import OptimizationParams as JOpt
from gaussianavatar_tpu.engine.optim import build_optimizer as j_build_optimizer
from gaussianavatar_tpu.engine.train_step import init_state, make_train_step as j_make_train_step
from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gaussianavatar_tpu.ops.ssim import l1_loss as j_l1, psnr as j_psnr, ssim as j_ssim
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
from gaussianavatar_tpu.utils.synthetic import synthetic_pose

from gaussianavatar_torch import bridge
from gaussianavatar_torch.config import OptimizationParams
from gaussianavatar_torch.engine.optim import build_optimizer
from gaussianavatar_torch.engine.train_step import make_train_step
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.models.layers import FlaxBatchNorm
from gaussianavatar_torch.ops import ssim as tssim
from gaussianavatar_torch.ops.rasterize import RasterizeConfig
from gaussianavatar_torch.utils.synthetic import synthetic_body

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# SSIM, PSNR, L1
# --------------------------------------------------------------------------

def test_image_losses_match_jax():
    """Values to 1e-6 and SSIM's gradient to 1e-5 of its largest entry: the
    same separable f32 filter, summed in another order; the gradient runs
    through the E[x^2] - mu^2 cancellations, which lift that noise (1.4e-6
    measured)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(2, 3, 40, 48)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b)
    t_ssim = tssim.ssim(ta, tb)
    t_ssim.backward()
    t_ssim = t_ssim.detach()
    j_val, j_grad = jax.value_and_grad(j_ssim)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(t_ssim), float(j_val), rtol=0, atol=1e-6)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(ta.grad.numpy(), j_grad, rtol=0, atol=1e-5 * np.abs(j_grad).max())
    np.testing.assert_allclose(tssim.ssim(torch.tensor(a), torch.tensor(b), size_average=False)
                               .numpy(), np.asarray(j_ssim(a, b, size_average=False)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tssim.psnr(torch.tensor(a), torch.tensor(b)).numpy(),
                               np.asarray(j_psnr(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(tssim.l1_loss(torch.tensor(a), torch.tensor(b))),
                               float(j_l1(a, b)), rtol=1e-6)


# --------------------------------------------------------------------------
# BatchNorm in training mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_matches_flax(dtype):
    """Output, gradients and running statistics after two training calls
    against flax nn.BatchNorm (momentum 0.9, biased variance). f32: 2e-6
    (sums in another order); bf16 (the decoder's mode): one bf16 ulp of
    the output's magnitude, statistics still f32 to 2e-6."""
    rng = np.random.default_rng(1)
    C = 6
    xs = [rng.normal(loc=0.5, scale=2.0, size=(2, 50, C)).astype(np.float32) for _ in range(2)]
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    cot = rng.normal(size=xs[0].shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    bn = fnn.BatchNorm(use_running_average=False, axis=-1, momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}
    tbn = FlaxBatchNorm(C).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.tensor(scale))
        tbn.bias.copy_(torch.tensor(bias))
    out_tol = 2e-6 if dtype == "float32" else 2.0 ** -7
    for x in xs:
        def j_fn(x_, params):
            y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              x_.astype(jdt), mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * cot), (y, upd)
        (_, (jy, upd)), (jgx, jgp) = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), variables["params"])
        variables["batch_stats"] = upd["batch_stats"]
        tx = torch.tensor(x, requires_grad=True)
        ty = tbn(tx.to(tdt))
        (ty.float() * torch.tensor(cot)).sum().backward()
        jy = np.asarray(jy.astype(jnp.float32))
        np.testing.assert_allclose(ty.float().detach().numpy(), jy, rtol=0,
                                   atol=out_tol * np.abs(jy).max())
        for t, j in ((tx.grad, jgx), (tbn.weight.grad, jgp["scale"]), (tbn.bias.grad, jgp["bias"])):
            j = np.asarray(j, np.float32)
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=out_tol * np.abs(j).max())
        tbn.weight.grad = tbn.bias.grad = None
        np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=0, atol=2e-6)
        np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                                   rtol=2e-6)
    # a render under no_grad normalises with batch statistics but leaves the
    # running ones alone
    before = (tbn.running_mean.clone(), tbn.running_var.clone())
    with torch.no_grad():
        tbn(torch.tensor(xs[0]).to(tdt))
    assert torch.equal(tbn.running_mean, before[0]) and torch.equal(tbn.running_var, before[1])


# --------------------------------------------------------------------------
# The optimizer groups
# --------------------------------------------------------------------------

class _Params(torch.nn.Module):
    """Parameters named as AvatarNet's: one net group member, geo, embeddings."""

    def __init__(self, p):
        super().__init__()
        self.pop = torch.nn.Module()
        self.pop.w = torch.nn.Parameter(torch.tensor(p["pop"]["w"]))
        self.geo_feature = torch.nn.Parameter(torch.tensor(p["geo_feature"]))
        self.pose_embedding = torch.nn.Parameter(torch.tensor(p["pose_embedding"]))
        self.transl_embedding = torch.nn.Parameter(torch.tensor(p["transl_embedding"]))


def test_optimizer_trajectory_matches_optax():
    """Seven steps of the three stage-1 groups against optax, the schedule's
    milestones (iteration unit, 2 and 4) crossed inside, embedding rows with
    zero gradient, and one step where no embedding row is touched (the
    SparseAdam step must not advance). Bound 1e-6 relative to each
    parameter's scale: the same f32 expressions, pow rounded by another
    library."""
    rng = np.random.default_rng(2)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    params = {"pop": {"w": f32(5, 3)}, "geo_feature": f32(1, 4, 4, 2),
              "pose_embedding": f32(6, 4), "transl_embedding": f32(6, 3)}
    jcfg = JOpt(sched_milestones=[2, 4], sched_unit="iteration")
    tcfg = OptimizationParams(sched_milestones=[2, 4], sched_unit="iteration")
    tx = j_build_optimizer(params, jcfg, steps_per_epoch=3, train_stage=1)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    mod = _Params(params)
    opt = build_optimizer(mod, tcfg, steps_per_epoch=3)
    named = dict(mod.named_parameters())
    for step in range(7):
        grads = jax.tree.map(lambda x: f32(*x.shape), params)
        for k in ("pose_embedding", "transl_embedding"):
            grads[k][rng.uniform(size=grads[k].shape[0]) < 0.5] = 0.0
            if step == 3:
                grads[k][:] = 0.0
        upd, js = tx.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in named.items():
            g = grads["pop"]["w"] if name == "pop.w" else grads[name]
            p.grad = torch.tensor(g)
        opt.step()
        for name, p in named.items():
            j = np.asarray(jp["pop"]["w"] if name == "pop.w" else jp[name])
            np.testing.assert_allclose(p.detach().numpy(), j, rtol=0, atol=1e-6 * np.abs(j).max(),
                                       err_msg=f"{name} after step {step + 1}")
    assert int(opt.groups["embed"].step_count) == 6


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------

H = W = 32
N_FRAMES, B, START_IT = 4, 2, 20
JCFG = JRasterizeConfig(tile_size=16, tile_capacity=1024, max_tiles_per_gaussian=16,
                        backend="pallas_interpret", sort_stable=True)
TCFG = RasterizeConfig(16, 16)
NET_KW = dict(num_frames=N_FRAMES, c_geom=8, inp_posmap_size=16, hsize=16)


class _TX0:
    def init(self, p):
        return None


def _record_grads():
    """An optax transformation that applies nothing and keeps the gradients
    as its state: the JAX step's gradients, read after the step."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def runs():
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    asset_args = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt, np.zeros(J * 3, np.float32),
                  np.zeros(4, np.float32))
    ja = j_build_assets(jm, *asset_args, query_res=32, pad_to=64)
    poses = np.stack([synthetic_pose(jm, t / N_FRAMES) for t in range(N_FRAMES)])
    jnet = JAvatarNet(pose_dim=J * 3, pose_init=poses, **NET_KW)
    st0 = init_state(jnet, ja, _TX0(), rng=jax.random.PRNGKey(5), batch_size=B)
    st0 = st0.replace(iteration=jnp.int32(START_IT))
    opt_cfg = JOpt()

    rng = np.random.default_rng(3)
    bank = rng.integers(0, 256, size=(N_FRAMES, 3, H, W)).astype(np.uint8)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                  np.array([0.0, -0.8, 1.6], np.float32), K, H, W)
    rep = lambda x: np.repeat(np.asarray(x)[None], B, 0)
    batches = [{"pose_idx": rng.choice(N_FRAMES, B, replace=False).astype(np.int32),
                "world_view_transform": rep(cam.world_view_transform),
                "full_proj_transform": rep(cam.full_proj_transform),
                "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)} for _ in range(3)]
    gates = (np.float32(opt_cfg.lambda_rgl), np.float32(1.0), np.float32(0.0))

    copy = lambda t: jax.tree.map(lambda x: jnp.array(x), t)
    jbatch = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    rec_step = j_make_train_step(jnet, jm, ja, _record_grads(), opt_cfg, H, W, (1.0, 1.0, 1.0),
                                 JCFG, gt_bank=jnp.asarray(bank))
    st_rec = copy(st0).replace(opt_state=_record_grads().init(st0.params))
    st_rec, rec_terms, _ = rec_step(st_rec, jbatch(batches[0]), *gates)
    j_grads = jax.tree.map(np.asarray, st_rec.opt_state)

    tx = j_build_optimizer(st0.params, opt_cfg, steps_per_epoch=2, train_stage=1)
    st = copy(st0).replace(opt_state=tx.init(st0.params))
    step = j_make_train_step(jnet, jm, ja, tx, opt_cfg, H, W, (1.0, 1.0, 1.0), JCFG,
                             gt_bank=jnp.asarray(bank))
    j_traj = []
    for b in batches:
        st, terms, _ = step(st, jbatch(b), *gates)
        j_traj.append((bridge.state_dict_from_jax(jax.tree.map(np.asarray, st.params),
                                                  jax.tree.map(np.asarray, st.batch_stats)),
                       {k: float(v) for k, v in terms.items()}, int(st.iteration)))

    tm, _ = synthetic_body()
    ta = build_avatar_assets(tm, *asset_args, query_res=32, pad_to=64, device="cpu")
    tnet = AvatarNet(pose_dim=J * 3, device="cpu", **NET_KW)
    tstate = bridge.train_state_from_jax(
        tnet, build_optimizer(tnet, OptimizationParams(), steps_per_epoch=2),
        jax.tree.map(np.asarray, st0.params), jax.tree.map(np.asarray, st0.batch_stats),
        st0.iteration)
    t_step = make_train_step(tnet, tm, ta, OptimizationParams(), H, W, (1.0, 1.0, 1.0), TCFG,
                             torch.tensor(bank))
    t_traj, t_grads = [], None
    for b in batches:
        terms, images = t_step(tstate, b, *(float(g) for g in gates))
        if t_grads is None:
            t_grads = {k: p.grad.clone() for k, p in tnet.named_parameters()}
        t_traj.append(({k: v.clone() for k, v in tnet.state_dict().items()},
                       {k: float(v) for k, v in terms.items()}, tstate.iteration))
    grads_sd = bridge.state_dict_from_jax(j_grads, jax.tree.map(np.asarray, st0.batch_stats))
    return {"j_traj": j_traj, "t_traj": t_traj, "j_terms1": {k: float(v) for k, v in
                                                             rec_terms.items()},
            "j_grads": grads_sd, "t_grads": t_grads, "images": images}


def _loose(name):
    """The Dense biases that feed a BatchNorm: true gradient exactly zero."""
    return name.startswith("pop.decoder.dense.") and name.endswith(".bias") and \
        name.split(".")[3] not in ("7", "10", "13")


def test_train_step_gradients_match_jax(runs):
    """First step: loss terms to 1e-5 relative, gradients to 2e-4 of each
    parameter's largest |gradient| (float noise through LBS, binning and
    the blend; the zero-gradient biases are compared against 1e-6 of the
    whole net's gradient scale)."""
    assert runs["images"].shape == (B, 3, H, W) and bool(torch.isfinite(runs["images"]).all())
    t_terms = runs["t_traj"][0][1]
    for k, v in runs["j_terms1"].items():
        np.testing.assert_allclose(t_terms[k], v, rtol=1e-5, atol=1e-9, err_msg=k)
    assert t_terms["raster_overflow"] == 0.0
    scale = max(float(runs["j_grads"][name].abs().max()) for name in runs["t_grads"])
    for name, tg in runs["t_grads"].items():
        jg = runs["j_grads"][name].numpy()
        assert np.isfinite(tg.numpy()).all(), name
        tol = 1e-6 * scale if _loose(name) else 2e-4 * np.abs(jg).max()
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=tol, err_msg=name)
    for name in ("geo_feature", "pose_embedding", "transl_embedding"):
        assert np.abs(runs["j_grads"][name].numpy()).max() > 0, name


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_trajectory_matches_jax(runs, n_steps):
    """Parameters, BatchNorm running statistics, loss terms and the
    iteration after 1 and after 3 steps. geo_feature and the embeddings to
    2e-5 absolute (lr-sized steps, float-noise gradients), the running
    variances to 1e-5 relative, the other parameters to 1e-4, and the
    BatchNorm-absorbed Dense biases to 2 x lr_net per step (a sign flip);
    the running means follow those biases."""
    t_sd, t_terms, t_it = runs["t_traj"][n_steps - 1]
    j_sd, j_terms, j_it = runs["j_traj"][n_steps - 1]
    assert t_it == j_it == START_IT + n_steps
    for k, v in j_terms.items():
        np.testing.assert_allclose(t_terms[k], v, rtol=1e-4, atol=1e-9, err_msg=k)
    for name, jv in j_sd.items():
        tv, jv = t_sd[name].numpy(), jv.numpy()
        if name in ("geo_feature", "pose_embedding", "transl_embedding"):
            tol = 2e-5
        elif name.endswith("running_var"):
            tol = 1e-5 * np.abs(jv).max()
        elif name.endswith("running_mean"):
            # a batch mean carries the loose bias of the Dense layer before it:
            # 0.1 x (up to 2 x lr_net x (n - 1)) from each of the n updates
            tol = 1e-5 * np.abs(jv).max() + 0.2 * JOpt().lr_net * n_steps * (n_steps - 1)
        elif _loose(name):
            tol = 2 * JOpt().lr_net * n_steps
        else:
            tol = 1e-4
        np.testing.assert_allclose(tv, jv, rtol=0, atol=tol, err_msg=f"{name} after {n_steps}")
