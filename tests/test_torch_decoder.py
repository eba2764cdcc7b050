"""Port parity, decoder stack: GeomConvLayers, pop_upsample, ShapeDecoder,
POPDecoder and AvatarNet.decode at inference, with the JAX weights carried
across by gaussianavatar_torch.bridge.

float32 (bf16_decoder=0 on both sides) is held tightly: the two differ only
by the summation order of matmuls and convolutions. bf16 is held loosely:
the two frameworks may round bf16 matmul outputs and activations at
different places, so the bound is one bf16 ulp at 1.0 (2^-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.engine.train_step import init_state
from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.models.decoder import ShapeDecoder as JShapeDecoder
from gaussianavatar_tpu.models.layers import Conv2DBlock as JConv2DBlock
from gaussianavatar_tpu.models.layers import GeomConvLayers as JGeomConvLayers
from gaussianavatar_tpu.ops.resample import pop_upsample as j_pop_upsample
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body

from gaussianavatar_torch import bridge
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.models.decoder import ShapeDecoder
from gaussianavatar_torch.models.layers import Conv2DBlock, GeomConvLayers
from gaussianavatar_torch.ops.resample import pop_upsample
from gaussianavatar_torch.utils.synthetic import synthetic_body

torch.set_num_threads(2)

F32_ATOL = 1e-5
BF16_ATOL = 2.0**-8


def _np(x):
    return np.asarray(x.detach().cpu().float())


def _random_bn_stats(stats, seed):
    """Non-trivial running statistics, so BN at inference is exercised."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in stats.items():
        n = np.asarray(s["mean"]).shape[0]
        out[name] = {"mean": rng.normal(scale=0.3, size=n).astype(np.float32),
                     "var": rng.uniform(0.5, 2.0, size=n).astype(np.float32)}
    return out


def test_geom_conv_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)  # NHWC
    jmod = JGeomConvLayers(8, 8)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_j = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod = GeomConvLayers(8, 8, 8)
    tmod.load_state_dict(bridge.geom_conv_state_dict(jax.tree.map(np.asarray, variables["params"])))
    with torch.no_grad():
        y_t = tmod(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(y_t), y_j, atol=F32_ATOL)


def test_conv2d_block_matches_jax():
    """LeakyReLU -> Conv(4, 2, 1) -> affine-free BatchNorm at inference."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 16, 6)).astype(np.float32)  # NHWC
    jmod = JConv2DBlock(8)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    stats = {"BatchNorm_0": {"mean": rng.normal(scale=0.3, size=8).astype(np.float32),
                             "var": rng.uniform(0.5, 2.0, size=8).astype(np.float32)}}
    y_j = np.asarray(jmod.apply({"params": variables["params"], "batch_stats": stats},
                                jnp.asarray(x), train=False))
    tmod = Conv2DBlock(6, 8).eval()
    tmod.load_state_dict({
        "conv.weight": torch.tensor(np.asarray(variables["params"]["Conv_0"]["kernel"])
                                    .transpose(3, 2, 0, 1)),
        "bn.running_mean": torch.tensor(stats["BatchNorm_0"]["mean"]),
        "bn.running_var": torch.tensor(stats["BatchNorm_0"]["var"]),
    })
    with torch.no_grad():
        y_t = tmod(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(y_t), y_j, atol=F32_ATOL)


def test_pop_upsample_matches_jax():
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)  # NHWC
    y_j = np.asarray(j_pop_upsample(jnp.asarray(feat), 33))
    y_t = pop_upsample(torch.as_tensor(feat).permute(0, 3, 1, 2), 33).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(y_t), y_j, atol=1e-6)


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
def test_shape_decoder_matches_jax(dtype, atol):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 300, 10)).astype(np.float32)
    jmod = JShapeDecoder(hsize=16, compute_dtype=dtype)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _random_bn_stats(jax.tree.map(np.asarray, variables["batch_stats"]), 4)
    outs_j = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    tmod = ShapeDecoder(10, hsize=16, compute_dtype=dtype).eval()
    tmod.load_state_dict(bridge.shape_decoder_state_dict(params, stats))
    with torch.no_grad():
        outs_t = tmod(torch.as_tensor(x))
    for name, a, b in zip(("xyz", "scales", "shs"), outs_t, outs_j):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def small_avatar():
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    args = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt, np.zeros(J * 3, np.float32),
            np.zeros(4, np.float32))
    ja = j_build_assets(jm, *args, query_res=32, pad_to=64)
    tm, _ = synthetic_body()
    ta = build_avatar_assets(tm, *args, query_res=32, pad_to=64, device="cpu")
    return J, ja, ta


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
def test_avatar_decode_matches_jax(small_avatar, dtype, atol):
    """POPDecoder + AvatarNet.decode at inference, weights through
    bridge.state_dict_from_jax (the whole stage-1 tree)."""
    J, ja, ta = small_avatar
    jnet = JAvatarNet(num_frames=3, pose_dim=J * 3, c_geom=8, inp_posmap_size=16, hsize=16,
                      compute_dtype=dtype)

    class _TX0:
        def init(self, p):
            return None

    st = init_state(jnet, ja, _TX0(), rng=jax.random.PRNGKey(5), batch_size=1)
    params = jax.tree.map(np.asarray, st.params)
    stats = {"pop": {"ShapeDecoder_0": _random_bn_stats(
        jax.tree.map(np.asarray, st.batch_stats["pop"]["ShapeDecoder_0"]), 6)}}

    def run(module):
        return module.decode(ja, 1, train=False)

    res_j, scales_j, shs_j, _ = jnet.apply({"params": params, "batch_stats": stats}, method=run)

    tnet = AvatarNet(3, J * 3, c_geom=8, inp_posmap_size=16, hsize=16, compute_dtype=dtype,
                     device="cpu").eval()
    tnet.load_state_dict(bridge.state_dict_from_jax(params, stats))
    with torch.no_grad():
        res_t, scales_t, shs_t, pose_featmap = tnet.decode(ta, 1)
    assert pose_featmap is None   # stage 1: no pose encoder
    # offsets are x0.02, so their tolerance scales with it
    np.testing.assert_allclose(_np(res_t), np.asarray(res_j), atol=0.02 * atol)
    np.testing.assert_allclose(_np(scales_t), np.asarray(scales_j), atol=atol)
    np.testing.assert_allclose(_np(shs_t), np.asarray(shs_j), atol=atol)
