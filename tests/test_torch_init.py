"""The port's initial network at `init="flax"` (the CLIs' `--init flax`)
against the JAX package's `init_state` (ROADMAP F19, F20): flax's
distribution and, since the port draws from JAX's own random stream
(models/init.py), JAX's values for the same seed. Small widths (c_geom 8,
hsize 16-32, input posmap 16 in stage 1 and 32 in stage 2, whose UNet
halves it five times), both decoders, the 'conv' and 'bottleneck'
smoothers, stage 2's pose encoder with 'upconv'.

For every leaf that `bridge.state_dict_from_jax` maps from a JAX
`init_state`:
  - biases, BatchNorm biases and running means are exactly 0 on both sides,
    BatchNorm scales and running variances exactly 1;
  - every kernel, on both sides, is flax's lecun_normal: fan_in taken on
    the flax layout (every axis of the flax kernel but the last), each
    sample |w| <= 2.0001 sqrt(1 / fan_in) / 0.8796 (the normal truncated at
    2 sigma), and the root mean square within 5 / sqrt(2 n) + 0.01 relative
    of sqrt(1 / fan_in), n the elements (a 5-sigma bound of a normal
    sample's spread, plus 1%); kernels of fewer than 256 elements are
    pooled by fan_in;
  - geo_feature's root mean square is 0.01 within the same bound;
  - the embeddings equal their initial poses.
Then every leaf equals JAX's from the same seed, one seed gives the same
state twice and two seeds different states, and `setup_avatar` (the CLIs'
path) builds each initialisation it is asked for."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
from gaussianavatar_tpu.utils.synthetic import synthetic_pose

from gaussianavatar_torch import bridge
from gaussianavatar_torch.models.avatar import AvatarNet

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from torch_init_compare import init_pairs  # noqa: E402

torch.set_num_threads(2)

N_FRAMES = 3
TRUNC_STD = 0.8796
MIN_ALONE = 256

CASES = {
    "stage1-ref-conv": dict(train_stage=1, decoder_impl="ref", geom_layer_type="conv",
                            hsize=16, inp_posmap_size=16),
    "stage1-fused-bottleneck": dict(train_stage=1, decoder_impl="fused",
                                    geom_layer_type="bottleneck", hsize=32,
                                    inp_posmap_size=16),
    "stage2-ref-conv": dict(train_stage=2, decoder_impl="ref", geom_layer_type="conv",
                            hsize=32, inp_posmap_size=32),
    "stage2-fused-bottleneck": dict(train_stage=2, decoder_impl="fused",
                                    geom_layer_type="bottleneck", hsize=16,
                                    inp_posmap_size=32),
}
COMMON = dict(num_frames=N_FRAMES, c_geom=8, c_pose=8, nf=4, up_mode="upconv")


@pytest.fixture(scope="module")
def body():
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    ja = j_build_assets(jm, uv.verts, uv.uvs, uv.faces_v, uv.faces_vt,
                        np.zeros(J * 3, np.float32), np.zeros(4, np.float32),
                        query_res=32, pad_to=64)
    poses = np.stack([synthetic_pose(jm, t / N_FRAMES) for t in range(N_FRAMES)])
    return ja, J, poses.astype(np.float32)


def _rms_ok(values: np.ndarray, target: float) -> bool:
    n = values.size
    rms = math.sqrt(float(np.mean(np.square(values, dtype=np.float64))))
    return abs(rms / target - 1.0) <= 5.0 / math.sqrt(2 * n) + 0.01


def _check_kernels(kernels, side):
    """kernels: [(name, fan_in, array)] -> every bound above, pooling the
    small ones by fan_in."""
    pools = {}
    for name, fan_in, w in kernels:
        std = math.sqrt(1.0 / fan_in)
        assert np.abs(w).max() <= 2.0001 * std / TRUNC_STD, f"{side} {name}: beyond 2 sigma"
        if w.size >= MIN_ALONE:
            assert _rms_ok(w, std), f"{side} {name}: rms {np.sqrt(np.mean(w * w))} vs {std}"
        else:
            pools.setdefault(fan_in, []).append(w.ravel())
    for fan_in, ws in pools.items():
        pooled = np.concatenate(ws)
        assert _rms_ok(pooled, math.sqrt(1.0 / fan_in)), f"{side} pool fan_in {fan_in}"


@pytest.mark.parametrize("case", list(CASES))
def test_initial_state_is_flax_lecun_normal(body, case):
    ja, J, poses = body
    kw = dict(COMMON, **CASES[case])
    pairs, sd = init_pairs(ja, J, kw, poses)

    mapped = set()
    j_kernels, t_kernels = [], []
    for key, path, a, t in pairs:
        mapped.add(key)
        assert t.shape == bridge.to_port(path, a).shape, key
        leaf = path[-1]
        if leaf in ("bias", "mean"):
            assert not a.any() and not t.any(), f"{key}: not all zero"
        elif leaf in ("scale", "var"):
            assert (a == 1).all() and (t == 1).all(), f"{key}: not all one"
        elif leaf == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            j_kernels.append(("/".join(path), fan_in, a))
            t_kernels.append((key, fan_in, t))
        elif key == "geo_feature":
            assert _rms_ok(a, 0.01) and _rms_ok(t, 0.01), key
        elif key == "pose_embedding":
            np.testing.assert_array_equal(t, poses)
            np.testing.assert_array_equal(a, poses)
        elif key == "transl_embedding":
            assert not a.any() and not t.any(), key
        else:
            raise AssertionError(f"unchecked leaf {key}")
    assert mapped == set(sd), sorted(set(sd) ^ mapped)
    assert len(t_kernels) >= (14 + 3 + 10 * (kw["train_stage"] == 2))
    _check_kernels(j_kernels, "JAX")
    _check_kernels(t_kernels, "port")


@pytest.mark.parametrize("case", list(CASES))
def test_initial_state_equals_jax_init_state(body, case):
    """Every leaf of the port's seed-0 network equals JAX's init_state
    (PRNGKey(0)) to 1e-5 of the leaf's largest |value|: the same keys, bits
    and float32 arithmetic, but the inverse error function in float64 where
    XLA's float32 one is off by an ulp or two (4.4e-6 measured, on
    geo_feature's tails)."""
    ja, J, poses = body
    kw = dict(COMMON, **CASES[case])
    pairs, _ = init_pairs(ja, J, kw, poses)
    for key, path, a, t in pairs:
        j = bridge.to_port(path, a).numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * max(np.abs(j).max(), 1e-30),
                                   err_msg=key)


def test_initial_state_follows_the_seed(body):
    _, J, poses = body
    kw = dict(COMMON, **CASES["stage2-fused-bottleneck"])
    make = lambda seed: AvatarNet(pose_dim=J * 3, pose_init=poses, device="cpu", init="flax",
                                  generator=torch.Generator().manual_seed(seed), **kw).state_dict()
    a, again, other = make(3), make(3), make(4)

    def default():
        """No generator: the seed of torch's default one (the CLIs pass a
        generator seeded 0 at `--init flax`, engine/setup.setup_avatar, as
        JAX's init_state defaults to PRNGKey(0))."""
        torch.manual_seed(0)
        return AvatarNet(pose_dim=J * 3, pose_init=poses, device="cpu", init="flax",
                         **kw).state_dict()

    d1, d2 = default(), default()
    for key, v in a.items():
        assert torch.equal(v, again[key]), key
        assert torch.equal(d1[key], d2[key]), key
        if key == "geo_feature" or (key.endswith("weight") and v.dim() > 1):
            assert not torch.equal(v, other[key]), key


@pytest.mark.parametrize("seed", [0, 5, 2**32 - 1, 2**32 + 7, 2**40 + 3, 2**63 - 1])
def test_prng_key_matches_jax(body, seed):
    """models/init.prng_key(seed) is jax.random.PRNGKey(seed) as the JAX
    package makes it (64-bit types off): seeds of 2**32 and more too, where
    JAX keeps the low 32 bits. A generator with such a seed, as torch's
    default one has after `torch.seed()`, draws the network of its low 32
    bits."""
    import jax

    from gaussianavatar_torch.models.init import prng_key

    assert not jax.config.jax_enable_x64
    np.testing.assert_array_equal(prng_key(seed), np.asarray(jax.random.PRNGKey(seed)))
    _, J, poses = body
    kw = dict(COMMON, **CASES["stage1-ref-conv"])
    make = lambda s: AvatarNet(pose_dim=J * 3, pose_init=poses, device="cpu", init="flax",
                               generator=torch.Generator().manual_seed(s), **kw).state_dict()
    big, low = make(seed), make(seed & 0xFFFFFFFF)
    for key, v in big.items():
        assert torch.equal(v, low[key]), key


@pytest.mark.parametrize("init", ["torch", "flax"])
def test_setup_avatar_takes_the_init(tmp_path, init):
    """setup_avatar(init=) as the train CLIs call it: "flax" is AvatarNet at
    init="flax" from a generator seeded `seed`, biases zero; "torch" keeps
    torch's layer defaults (biases drawn, not zero)."""
    from gaussianavatar_torch.config import Config, ModelParams, NetworkParams
    from gaussianavatar_torch.config import OptimizationParams, RasterParams
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine.setup import setup_avatar

    write_synthetic_dataset(str(tmp_path), n_train=2, n_test=1, image_size=32, device="cpu")
    cfg = Config(ModelParams(source_path=str(tmp_path), dataset_type="synthetic",
                             query_posmap_size=32, inp_posmap_size=16),
                 NetworkParams(c_geom=8, hsize=16), OptimizationParams(), RasterParams())
    net = setup_avatar(cfg, device="cpu", seed=3, init=init).net
    biases = [m.bias for m in net.modules()
              if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)) and m.bias is not None]
    assert biases and all(bool((b == 0).all()) == (init == "flax") for b in biases)
    if init == "flax":
        again = setup_avatar(cfg, device="cpu", seed=3, init=init).net.state_dict()
        for k, v in net.state_dict().items():
            assert torch.equal(v, again[k]), k
