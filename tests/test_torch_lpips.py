"""Port parity, LPIPS: gaussianavatar_torch/ops/lpips.py against
gaussianavatar_tpu/ops/lpips.py on random weights of the exact layout (no
pretrained weights ship with the repository), its loaders against the JAX
package's on the same files, and the stage-1 train step with the LPIPS term
at gate 1 and gate 0 against JAX `make_train_step(lpips_fn=...)`.

Tolerances: the distance to 1e-5 relative and its input gradient to 1e-4
of the largest |gradient| (the same f32 convolutions, summed in another
order by another library); identical images give 0 to 1e-7; the loaders
give equal arrays. The train step's terms (`vgg` among them) to 1e-5
relative and its gradients to 2e-4 of each parameter's largest |gradient|,
the bounds of tests/test_torch_train.py (float noise through LBS, binning
and the blend, f32 decoder on both sides); at gate 0 the port's gradients
equal, bit for bit, those of a step without LPIPS."""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.ops import lpips as jl

from gaussianavatar_torch.ops import lpips as tl

torch.set_num_threads(2)

CFG = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3), (256, 256, 3)]


def random_weights(seed=0):
    """Random weights of the lpips_alex.npz layout, biases included."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (co, ci, k) in enumerate(CFG):
        out[f"conv{i}_w"] = rng.normal(scale=0.05, size=(co, ci, k, k)).astype(np.float32)
        out[f"conv{i}_b"] = rng.normal(scale=0.01, size=co).astype(np.float32)
        out[f"lin{i}"] = rng.uniform(0, 0.1, size=co).astype(np.float32)
    return out


def _images(seed, shape=(2, 3, 64, 64)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, size=shape).astype(np.float32) for _ in range(2)]


def test_distance_and_gradient_match_jax():
    w = random_weights()
    a, b = _images(1)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    j_val, j_grad = jax.value_and_grad(lambda x: jl.lpips_forward(jw, x, jnp.asarray(b)))(
        jnp.asarray(a))
    model = tl.LPIPS(w)
    ta = torch.tensor(a, requires_grad=True)
    t_val = model(ta, torch.tensor(b))
    t_val.backward()
    assert float(j_val) > 0
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-5, atol=0)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(ta.grad.numpy(), j_grad, rtol=0, atol=1e-4 * np.abs(j_grad).max())
    # the weights are buffers: no parameter, no gradient
    assert not list(model.parameters())
    assert all(not t.requires_grad for t in model.buffers())


def test_zero_for_identical_images():
    a, _ = _images(2, (1, 3, 64, 64))
    assert abs(float(tl.LPIPS(random_weights())(torch.tensor(a), torch.tensor(a)))) < 1e-7


def _fabricate_pth(d, wrap, weights):
    """A torchvision-AlexNet-like state dict (features.{0,3,6,8,10} plus a
    classifier entry) and lpips v0.1 heads ((1, C, 1, 1) under
    lin{i}.model.1.weight), saved with torch.save, optionally each under a
    `state_dict` key."""
    feat = {}
    for i, li in enumerate((0, 3, 6, 8, 10)):
        feat[f"features.{li}.weight"] = torch.tensor(weights[f"conv{i}_w"])
        feat[f"features.{li}.bias"] = torch.tensor(weights[f"conv{i}_b"])
    feat["classifier.1.weight"] = torch.zeros(4, 9)
    lins = {f"lin{i}.model.1.weight": torch.tensor(weights[f"lin{i}"]).reshape(1, -1, 1, 1)
            for i in range(5)}
    os.makedirs(d, exist_ok=True)
    paths = (os.path.join(d, "alexnet.pth"), os.path.join(d, "alex.pth"))
    for obj, p in zip((feat, lins), paths):
        torch.save({"state_dict": obj} if wrap else obj, p)
    return paths


@pytest.mark.parametrize("wrap", [False, True], ids=["bare", "state_dict"])
def test_weights_from_pth_matches_jax(tmp_path, wrap):
    w = random_weights(3)
    alexnet, lins = _fabricate_pth(str(tmp_path), wrap, w)
    ours = tl.weights_from_pth(alexnet, lins)
    theirs = jl.weights_from_pth(alexnet, lins)
    assert ours.keys() == theirs.keys() == w.keys()
    for k in w:
        assert ours[k].dtype == np.float32 and np.array_equal(ours[k], theirs[k]), k
        assert np.array_equal(ours[k], w[k]), k
    # a wrong out-channel count and a missing head are refused by both
    feat = torch.load(alexnet, weights_only=True)
    feat = feat.get("state_dict", feat)
    feat["features.0.weight"] = feat["features.0.weight"][:32]
    torch.save(feat, alexnet)
    for read in (tl.weights_from_pth, jl.weights_from_pth):
        with pytest.raises(ValueError, match="out-channels"):
            read(alexnet, lins)
    torch.save({"lin0.model.1.weight": torch.zeros(1, 64, 1, 1)}, lins)
    _fabricate_pth(str(tmp_path / "ok"), False, w)
    for read in (tl.weights_from_pth, jl.weights_from_pth):
        with pytest.raises(KeyError, match="no lin1 weight"):
            read(str(tmp_path / "ok" / "alexnet.pth"), lins)


def test_search_order_and_status_match_jax(tmp_path):
    """No weights: None and JAX's inactive string; the raw .pth pair alone:
    loaded; beside lpips_alex.npz: the npz wins. Each step against JAX's
    try_load_lpips on the same project."""
    proj = str(tmp_path / "proj")
    os.makedirs(proj)
    assert tl.try_load_lpips(proj) is None and jl.try_load_lpips(proj) is None
    assert tl.lpips_status(proj) == jl.lpips_status(proj) == tl.INACTIVE

    d = os.path.join(proj, "assets", "lpips")
    w_pth, w_npz = random_weights(4), random_weights(5)
    _fabricate_pth(d, False, w_pth)
    for want in (w_pth, w_npz):
        if want is w_npz:
            np.savez(os.path.join(d, "lpips_alex.npz"), **w_npz)
        ours, theirs = tl.try_load_lpips(proj), jl.try_load_lpips(proj)
        assert isinstance(theirs, partial)
        for k, v in want.items():
            mine = getattr(ours, k).reshape(-1).numpy() if k.startswith("lin") \
                else getattr(ours, k).numpy()
            assert np.array_equal(mine, v) and np.array_equal(np.asarray(theirs.args[0][k]), v)
        assert tl.lpips_status(proj) == jl.lpips_status(proj) == "active"


# --------------------------------------------------------------------------
# The train step with the LPIPS term
# --------------------------------------------------------------------------

H = W = 32
N_FRAMES, B, START_IT = 4, 2, 20


@pytest.fixture(scope="module")
def lpips_steps():
    """The first stage-1 step from one JAX init_state in both packages, each
    gate (1, then 0), with the JAX gradients read through a recording
    transformation; the port also without LPIPS."""
    import optax

    from gaussianavatar_tpu.config import OptimizationParams as JOpt
    from gaussianavatar_tpu.engine.train_step import init_state, make_train_step as j_make
    from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
    from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
    from gaussianavatar_tpu.ops.camera import Camera as JCamera
    from gaussianavatar_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
    from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_body, synthetic_pose

    from gaussianavatar_torch import bridge
    from gaussianavatar_torch.config import OptimizationParams
    from gaussianavatar_torch.engine.optim import build_optimizer
    from gaussianavatar_torch.engine.train_step import make_train_step
    from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
    from gaussianavatar_torch.ops.rasterize import RasterizeConfig
    from gaussianavatar_torch.utils.synthetic import synthetic_body

    net_kw = dict(num_frames=N_FRAMES, c_geom=8, inp_posmap_size=16, hsize=16)
    jm, uv = j_body()
    J = jm.parents.shape[0]
    asset_args = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt, np.zeros(J * 3, np.float32),
                  np.zeros(4, np.float32))
    ja = j_build_assets(jm, *asset_args, query_res=32, pad_to=64)
    poses = np.stack([synthetic_pose(jm, t / N_FRAMES) for t in range(N_FRAMES)])
    jnet = JAvatarNet(pose_dim=J * 3, pose_init=poses, **net_kw)

    class _TX0:
        def init(self, p):
            return None

    st0 = init_state(jnet, ja, _TX0(), rng=jax.random.PRNGKey(5), batch_size=B)
    st0 = st0.replace(iteration=jnp.int32(START_IT))
    rng = np.random.default_rng(3)
    bank = rng.integers(0, 256, size=(N_FRAMES, 3, H, W)).astype(np.uint8)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                  np.array([0.0, -0.8, 1.6], np.float32), K, H, W)
    rep = lambda x: np.repeat(np.asarray(x)[None], B, 0)
    batch = {"pose_idx": np.array([2, 0], np.int32),
             "world_view_transform": rep(cam.world_view_transform),
             "full_proj_transform": rep(cam.full_proj_transform),
             "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)}
    w = random_weights(6)

    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jcfg = JRasterizeConfig(tile_size=16, tile_capacity=1024, max_tiles_per_gaussian=16,
                            backend="pallas_interpret", sort_stable=True)
    j_step = j_make(jnet, jm, ja, record, JOpt(), H, W, (1.0, 1.0, 1.0), jcfg,
                    lpips_fn=partial(jl.lpips_forward, {k: jnp.asarray(v) for k, v in w.items()}),
                    gt_bank=jnp.asarray(bank))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    bs0 = np_tree(st0.batch_stats)
    out = {}
    for gate in (1.0, 0.0):
        st = jax.tree.map(lambda x: jnp.array(x), st0).replace(opt_state=record.init(st0.params))
        st, terms, _ = j_step(st, {k: jnp.asarray(v) for k, v in batch.items()},
                              np.float32(JOpt().lambda_rgl), np.float32(1.0), np.float32(gate))
        out[("jax", gate)] = ({k: float(v) for k, v in terms.items()},
                              bridge.state_dict_from_jax(np_tree(st.opt_state), bs0))

    tm, _ = synthetic_body()
    ta = build_avatar_assets(tm, *asset_args, query_res=32, pad_to=64, device="cpu")
    model = tl.LPIPS(w)
    for gate, fn in ((1.0, model), (0.0, model), (None, None)):
        tnet = AvatarNet(pose_dim=J * 3, device="cpu", **net_kw)
        state = bridge.train_state_from_jax(
            tnet, build_optimizer(tnet, OptimizationParams(), steps_per_epoch=2),
            np_tree(st0.params), bs0, st0.iteration)
        step = make_train_step(tnet, tm, ta, OptimizationParams(), H, W, (1.0, 1.0, 1.0),
                               RasterizeConfig(16, 16), torch.tensor(bank), lpips_fn=fn)
        terms, _ = step(state, batch, OptimizationParams().lambda_rgl, 1.0, gate or 0.0)
        out[("torch", gate)] = ({k: float(v) for k, v in terms.items()},
                                {k: p.grad.clone() for k, p in tnet.named_parameters()})
    return out


def _loose(name):
    """The Dense biases that feed a BatchNorm: true gradient exactly zero."""
    return name.startswith("pop.decoder.dense.") and name.endswith(".bias") and \
        name.split(".")[3] not in ("7", "10", "13")


@pytest.mark.parametrize("gate", [1.0, 0.0], ids=["gate1", "gate0"])
def test_train_step_with_lpips_matches_jax(lpips_steps, gate):
    j_terms, j_grads = lpips_steps[("jax", gate)]
    t_terms, t_grads = lpips_steps[("torch", gate)]
    assert set(t_terms) == set(j_terms) and "vgg" in t_terms
    assert t_terms["vgg"] > 0
    for k, v in j_terms.items():
        np.testing.assert_allclose(t_terms[k], v, rtol=1e-5, atol=1e-9, err_msg=k)
    scale = max(float(j_grads[name].abs().max()) for name in t_grads)
    for name, tg in t_grads.items():
        jg = j_grads[name].numpy()
        tol = 1e-6 * scale if _loose(name) else 2e-4 * np.abs(jg).max()
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=tol, err_msg=name)


def test_gate_zero_leaves_no_gradient(lpips_steps):
    """At gate 0 the term is logged and nothing else: the gradients and the
    total equal those of a step without LPIPS, bit for bit; at gate 1 the
    term moves them."""
    t0_terms, t0_grads = lpips_steps[("torch", 0.0)]
    none_terms, none_grads = lpips_steps[("torch", None)]
    t1_terms, t1_grads = lpips_steps[("torch", 1.0)]
    assert "vgg" not in none_terms and t0_terms["total"] == none_terms["total"]
    assert t1_terms["total"] == pytest.approx(t0_terms["total"] + t1_terms["vgg"], rel=1e-6)
    for name, g in none_grads.items():
        assert torch.equal(t0_grads[name], g), name
    assert not torch.equal(t1_grads["geo_feature"], none_grads["geo_feature"])
