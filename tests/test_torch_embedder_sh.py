"""Port parity: the positional encoding (ops/embedder), the POP decoder with
`pos_encoding`, spherical-harmonics colours (ops/sh) and the single-view
`rasterize` with SH coefficients, each against the JAX package on the same
numpy inputs.

Tolerances: the embedder and eval_sh to 1e-6 (the same float32 expressions
in the same order); the decoder, f32 on both sides, to 1e-5 (matmul
summation order, as tests/test_torch_decoder.py); the SH render to 2e-5,
the blend's colour bound (tests/test_torch_raster.py), and its gradient
with respect to the coefficients to 1e-4 of its largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.engine.train_step import init_state
from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.ops.embedder import get_embedder as j_get_embedder
from gaussianavatar_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gaussianavatar_tpu.ops.rasterize import rasterize as j_rasterize
from gaussianavatar_tpu.ops.sh import eval_sh as j_eval_sh
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body

from gaussianavatar_torch import bridge
from gaussianavatar_torch.config import Config, ModelParams, NetworkParams, OptimizationParams
from gaussianavatar_torch.config import RasterParams
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.ops.camera import Camera
from gaussianavatar_torch.ops.embedder import get_embedder
from gaussianavatar_torch.ops.rasterize import RasterizeConfig, rasterize
from gaussianavatar_torch.ops.sh import eval_sh
from gaussianavatar_torch.utils.synthetic import synthetic_body

torch.set_num_threads(2)


@pytest.mark.parametrize("multires", [0, 6])
@pytest.mark.parametrize("include_input", [False, True])
@pytest.mark.parametrize("log_sampling", [False, True])
def test_embedder_matches_jax(multires, include_input, log_sampling):
    x = np.random.default_rng(0).uniform(-1, 1, size=(50, 2)).astype(np.float32)
    j_fn, j_dim = j_get_embedder(multires, 2, include_input, log_sampling)
    t_fn, t_dim = get_embedder(multires, 2, include_input, log_sampling)
    assert t_dim == j_dim
    out = t_fn(torch.tensor(x))
    assert out.shape == (50, t_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_fn(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(scale=0.5, size=(200, (deg + 1) ** 2, 3)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    out = eval_sh(deg, torch.tensor(sh), torch.tensor(dirs)).numpy()
    ref = np.asarray(j_eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    assert (out == 0).any() and (out > 0).any()   # the clamp bites somewhere
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend", ["tile", "brute"])
def test_rasterize_with_sh_matches_jax(backend):
    """One 32^2 view of 40 gaussians at sh_degree 3: the tile path (the
    port's blend; the JAX Pallas kernels in interpret mode, as
    tests/test_sh_embedder.py runs `rasterize`) and the brute path."""
    H = W = 32
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    cam_args = (np.eye(3, dtype=np.float32), np.array([0, 0, 2.0], np.float32), K, H, W)
    rng = np.random.default_rng(1)
    n = 40
    means = rng.normal(scale=0.2, size=(n, 3)).astype(np.float32)
    shs = rng.normal(scale=0.3, size=(n, 16, 3)).astype(np.float32)
    scales = rng.uniform(0.03, 0.08, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.5, 1.0, n).astype(np.float32)
    bg = np.ones(3, np.float32)
    cot = rng.normal(size=(3, H, W)).astype(np.float32)

    jcam = JCamera.from_extrinsics(*cam_args)
    jcfg = JRasterizeConfig(tile_size=16, tile_capacity=64, max_tiles_per_gaussian=16,
                            backend="pallas_interpret" if backend == "tile" else "brute")

    def j_render(s):
        return j_rasterize(jnp.asarray(means), None, jnp.asarray(scales), jnp.asarray(q),
                           jnp.asarray(opac), jcam, jnp.asarray(bg), config=jcfg, shs=s,
                           sh_degree=3)

    j_img, j_vjp = jax.vjp(j_render, jnp.asarray(shs))
    j_grad = np.asarray(j_vjp(jnp.asarray(cot))[0])

    t_shs = torch.tensor(shs, requires_grad=True)
    t_img = rasterize(torch.tensor(means), None, torch.tensor(scales), torch.tensor(q),
                      torch.tensor(opac), Camera.from_extrinsics(*cam_args, device="cpu"),
                      torch.tensor(bg), config=RasterizeConfig(16, 16, backend),
                      shs=t_shs, sh_degree=3)
    (t_img * torch.tensor(cot)).sum().backward()
    assert t_img.shape == (3, H, W)
    np.testing.assert_allclose(t_img.detach().numpy(), np.asarray(j_img), rtol=0, atol=2e-5)
    assert np.abs(j_grad).max() > 0
    np.testing.assert_allclose(t_shs.grad.numpy(), j_grad, rtol=0,
                               atol=1e-4 * np.abs(j_grad).max())


@pytest.mark.parametrize("incl", [False, True])
def test_pop_decoder_with_pos_encoding_matches_jax(incl):
    """AvatarNet.decode with `pos_encoding`, f32 on both sides, the JAX
    parameters carried across by bridge: the decoder's first layer takes
    c_geom + 2 (2 m + incl) inputs (88 at the defaults c_geom 64, m 6).
    At inference (random running statistics) every output to 1e-5, the
    offsets (x0.02) to 0.02 x 1e-5, as tests/test_torch_decoder.py; in
    training mode (batch statistics, whose sums in another order lift the
    noise to 5e-6) every output to 1e-5."""
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    args = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt, np.zeros(J * 3, np.float32),
            np.zeros(4, np.float32))
    ja = j_build_assets(jm, *args, query_res=32, pad_to=64)
    tm, _ = synthetic_body()
    ta = build_avatar_assets(tm, *args, query_res=32, pad_to=64, device="cpu")
    kw = dict(c_geom=8, inp_posmap_size=16, hsize=16, pos_encoding=True, num_emb_freqs=4,
              posemb_incl_input=incl)
    jnet = JAvatarNet(num_frames=2, pose_dim=J * 3, **kw)

    class _TX0:
        def init(self, p):
            return None

    st = init_state(jnet, ja, _TX0(), rng=jax.random.PRNGKey(5), batch_size=1)
    params = jax.tree.map(np.asarray, st.params)
    rng = np.random.default_rng(6)
    stats = {"pop": {"ShapeDecoder_0": {
        name: {"mean": rng.normal(scale=0.3, size=s["mean"].shape).astype(np.float32),
               "var": rng.uniform(0.5, 2.0, size=s["var"].shape).astype(np.float32)}
        for name, s in jax.tree.map(np.asarray, st.batch_stats)["pop"]["ShapeDecoder_0"].items()}}}
    tnet = AvatarNet(2, J * 3, device="cpu", **kw)
    tnet.load_state_dict(bridge.state_dict_from_jax(params, stats))
    width = 8 + 2 * (2 * 4 + incl)
    assert tnet.pop.decoder.dense[0].in_features == width
    assert params["pop"]["ShapeDecoder_0"]["Dense_0"]["kernel"].shape[0] == width
    for train, res_atol in ((False, 0.02 * 1e-5), (True, 1e-5)):
        (res_j, scales_j, shs_j, _), _ = jnet.apply(
            {"params": params, "batch_stats": stats},
            method=lambda module: module.decode(ja, 1, train=train), mutable=["batch_stats"])
        with torch.no_grad():
            res_t, scales_t, shs_t, _ = tnet.train(train).decode(ta, 1)
        np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=0, atol=res_atol)
        np.testing.assert_allclose(scales_t.numpy(), np.asarray(scales_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(shs_t.numpy(), np.asarray(shs_j), rtol=0, atol=1e-5)

    # the three fields round-trip through cfg_args.json, and the defaults
    # give the canonical decoder its 88 inputs
    import tempfile

    cfg = Config(ModelParams(), NetworkParams(pos_encoding=1, num_emb_freqs=4,
                                              posemb_incl_input=int(incl)),
                 OptimizationParams(), RasterParams())
    with tempfile.TemporaryDirectory() as d:
        cfg.save(d + "/cfg_args.json")
        back = Config.load(d + "/cfg_args.json").net
    assert (back.pos_encoding, back.num_emb_freqs, back.posemb_incl_input) == (1, 4, int(incl))
    canonical = AvatarNet(1, J * 3, pos_encoding=True, device="cpu")
    assert canonical.pop.decoder.dense[0].in_features == 88
