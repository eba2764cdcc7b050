"""Port parity, the stage-2 building blocks: `ConvTranspose4x4s2`,
`UpConv2DBlock` (upconv and upsample), `GeomConvBottleneckLayers` and
`UnetNoCond5DS` / `6DS` / `7DS`, each against the flax module of the JAX
package on the same weights, carried across by bridge (the transposed
convolution's kernel flipped, every other kernel HWIO -> OIHW) and the
same numpy input (NHWC there, NCHW here).

A ReLU's gradient jumps at 0, so an input within float noise of a kink
can put the two packages on its two sides and move an input gradient by
far more than float noise (one such value turned up with the first seed
of unet6: a BatchNorm output that rounds to exactly 0 on one side and to
one ulp on the other). Each case therefore first checks that no input of
a (leaky) ReLU of the port's forward lies within 2e-6 of the largest
|input| of 0 (twice the largest difference between a float32 and a
float64 forward activation of these modules, 1.2e-6 of that tensor's
largest value), and its seed was chosen so that none does.

Each case checks the forward in training mode, the BatchNorm running
statistics after that one training call (flax's rule: momentum 0.9, the
biased variance), the input gradient under a random cotangent, and the
forward in eval mode (running statistics), each to 1e-5 of the largest
|value| of what is compared: the same f32 convolutions, summed in another
order. Dropout is off: the two packages' random streams cannot agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.models import layers as jl

from gaussianavatar_torch import bridge
from gaussianavatar_torch.models import layers as tl

torch.set_num_threads(2)

TOL = 1e-5


def _port_state_dict(variables, prefix, strip):
    """flax variables of a submodule at `prefix` in the AvatarNet tree ->
    the port module's state_dict (its keys with `strip` taken off)."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, a in bridge._leaves(jax.tree.map(np.asarray, variables.get(coll, {}))):
            full = prefix + path
            key = bridge.port_key(full)
            assert key.startswith(strip), key
            sd[key[len(strip):]] = bridge.to_port(full, a)
    return sd


def _close(t, j, what):
    j = np.asarray(j, np.float32)
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL * max(np.abs(j).max(), 1e-30),
                               err_msg=what)


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def _nchw(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


# name -> (flax module, port module, input shape (NCHW), skip shape or None,
#          flax path prefix, port key prefix)
CASES = {
    "convT": (lambda: jl.ConvTranspose4x4s2(6),
              lambda: tl.ConvTranspose4x4s2(5, 6), (2, 5, 8, 8), None,
              ("pose_encoder", "UpConv2DBlock_0", "ConvTranspose4x4s2_0"),
              "pose_encoder.up.0.conv."),
    "convT_bias": (lambda: jl.ConvTranspose4x4s2(6, use_bias=True),
                   lambda: tl.ConvTranspose4x4s2(5, 6, use_bias=True), (2, 5, 8, 8), None,
                   ("pose_encoder", "UpConv2DBlock_0", "ConvTranspose4x4s2_0"),
                   "pose_encoder.up.0.conv."),
    "upconv_block": (lambda: jl.UpConv2DBlock(6, up_mode="upconv"),
                     lambda: tl.UpConv2DBlock(5, 6, up_mode="upconv"), (2, 5, 8, 8),
                     (2, 4, 16, 16), ("pose_encoder", "UpConv2DBlock_0"), "pose_encoder.up.0."),
    "upsample_block": (lambda: jl.UpConv2DBlock(6, up_mode="upsample"),
                       lambda: tl.UpConv2DBlock(5, 6, up_mode="upsample"), (2, 5, 8, 8),
                       (2, 4, 16, 16), ("pose_encoder", "UpConv2DBlock_0"),
                       "pose_encoder.up.0."),
    "last_block": (lambda: jl.UpConv2DBlock(3, use_bn=False, use_bias=True),
                   lambda: tl.UpConv2DBlock(5, 3, use_bias=True, use_bn=False), (2, 5, 8, 8),
                   None, ("pose_encoder", "UpConv2DBlock_4"), "pose_encoder.up.4."),
    "bottleneck": (lambda: jl.GeomConvBottleneckLayers(8, 16),
                   lambda: tl.GeomConvBottleneckLayers(16, 8, 16), (2, 16, 16, 16), None,
                   ("pop", "GeomConvBottleneckLayers_0"), "pop.geom."),
    "unet5_upconv": (lambda: jl.UnetNoCond5DS(16, 8, "upconv"),
                     lambda: tl.UnetNoCond5DS(3, 16, 8, "upconv"), (2, 3, 32, 32), None,
                     ("pose_encoder",), "pose_encoder."),
    "unet5_upsample": (lambda: jl.UnetNoCond5DS(16, 8, "upsample"),
                       lambda: tl.UnetNoCond5DS(3, 16, 8, "upsample"), (2, 3, 32, 32), None,
                       ("pose_encoder",), "pose_encoder."),
    "unet5_smoother": (lambda: jl.UnetNoCond5DS(16, 8, "upconv"),
                       lambda: tl.UnetNoCond5DS(16, 16, 8, "upconv"), (2, 16, 32, 32), None,
                       ("pop", "UnetNoCond5DS_0"), "pop.geom."),
    "unet6": (lambda: jl.UnetNoCond6DS(4, 4, "upconv"),
              lambda: tl.UnetNoCond6DS(3, 4, 4, "upconv"), (2, 3, 64, 64), None,
              ("pose_encoder",), "pose_encoder."),
    "unet7": (lambda: jl.UnetNoCond7DS(4, 4, "upconv"),
              lambda: tl.UnetNoCond7DS(3, 4, 4, "upconv"), (2, 3, 128, 128), None,
              ("pose_encoder",), "pose_encoder."),
}


# seeds of the cases' data; unet6's first seed met a ReLU kink (docstring)
SEEDS = {name: i for i, name in enumerate(sorted(CASES))} | {"unet6": 100}


def _min_kink_margin(module, x, skip):
    """The smallest |input| of a (leaky) ReLU in `module`'s forward,
    relative to the largest (inf where there is none)."""
    seen = []

    def pre(mod, args):
        if getattr(mod, "use_relu", True):
            seen.append(args[0].detach().abs())

    blocks = [m for m in module.modules() if isinstance(m, (tl.Conv2DBlock, tl.UpConv2DBlock))]
    handles = [b.register_forward_pre_hook(pre) for b in blocks]
    try:
        with torch.no_grad():
            module(torch.tensor(x)) if skip is None else module(torch.tensor(x), torch.tensor(skip))
    finally:
        for h in handles:
            h.remove()
    return min((float(a.min() / a.max()) for a in seen), default=float("inf"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_matches_flax(case):
    j_make, t_make, shape, skip_shape, prefix, strip = CASES[case]
    rng = np.random.default_rng(SEEDS[case])
    x = rng.normal(size=shape).astype(np.float32)
    skip = None if skip_shape is None else rng.normal(size=skip_shape).astype(np.float32)
    jm, tm = j_make(), t_make()
    has_train = not case.startswith("convT")

    def j_apply(variables, x_, train, mutable):
        args = (x_,) if skip is None else (x_, _nhwc(skip))
        kw = {"train": train} if has_train else {}
        if mutable:
            return jm.apply(variables, *args, mutable=["batch_stats"], **kw)
        return jm.apply(variables, *args, **kw), None

    init_kw = {"train": True} if has_train else {}
    variables = dict(jax.jit(lambda key, *a: jm.init(key, *a, **init_kw))(
        jax.random.PRNGKey(7), *((_nhwc(x),) if skip is None else (_nhwc(x), _nhwc(skip)))))
    # moved running statistics, so eval mode does not normalise with the init (0, 1)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree.map(
            lambda a: a + jnp.asarray(rng.uniform(0.1, 0.5, a.shape), a.dtype),
            variables["batch_stats"])
    tm.load_state_dict(_port_state_dict(variables, prefix, strip))
    assert _min_kink_margin(tm.train(), x, skip) > 2e-6, "a ReLU input sits at its kink"

    # training mode: output, input gradient, running statistics after the call
    # (one jitted program: XLA compiles it once rather than op by op)
    @jax.jit
    def j_train(variables, x_, cot_):
        (y, upd), vjp = jax.vjp(lambda a: j_apply(variables, a, True, True), x_)
        return y, upd, vjp((cot_, jax.tree.map(jnp.zeros_like, upd)))[0]

    out_shape = jax.eval_shape(lambda a: j_apply(variables, a, True, True)[0], _nhwc(x)).shape
    cot = rng.normal(size=out_shape).astype(np.float32)
    jy, upd, jgx = j_train(variables, _nhwc(x), jnp.asarray(cot))
    tm.train()
    tx = torch.tensor(x, requires_grad=True)
    ty = tm(tx) if skip is None else tm(tx, torch.tensor(skip))
    (ty * torch.tensor(_nchw(cot))).sum().backward()
    _close(ty, _nchw(jy), f"{case}: training-mode output")
    _close(tx.grad, _nchw(jgx), f"{case}: input gradient")
    if upd is not None and upd.get("batch_stats"):
        moved = _port_state_dict({"batch_stats": upd["batch_stats"]}, prefix, strip)
        own = tm.state_dict()
        assert moved
        for k, v in moved.items():
            _close(own[k], v.numpy(), f"{case}: {k} after one training call")
        variables = dict(variables, batch_stats=upd["batch_stats"])

    # eval mode, on the moved statistics
    jy_eval, _ = jax.jit(lambda v, a: j_apply(v, a, False, False))(variables, _nhwc(x))
    tm.eval()
    with torch.no_grad():
        ty_eval = tm(torch.tensor(x)) if skip is None else tm(torch.tensor(x), torch.tensor(skip))
    _close(ty_eval, _nchw(jy_eval), f"{case}: eval-mode output")


def test_dropout_draws_from_its_generator():
    """The 'unet' smoother's dropout: half the units kept, scaled by 2,
    the same mask from the same seed, none in eval mode."""
    x = torch.ones(2, 4, 8, 8)
    make = lambda seed: tl.UpConv2DBlock(4, 6, use_bn=False, use_dropout=True,
                                         generator=torch.Generator().manual_seed(seed))
    a, b = make(0), make(0)
    b.load_state_dict(a.state_dict())
    ya, yb = a(x), b(x)
    assert torch.equal(ya, yb)
    kept = ya != 0
    assert 0.35 < float(kept.float().mean()) < 0.65
    with torch.no_grad():
        full = a.conv(torch.relu(x))
    torch.testing.assert_close(ya[kept], 2 * full[kept])
    assert torch.equal(a.eval()(x), full)
