"""The initial weights of the JAX package's flax modules, drawn in numpy:
the very values `init_state(..., rng=PRNGKey(seed))` draws.

Flax's `nn.Dense`, `nn.Conv` and the JAX `ConvTranspose4x4s2` draw their
kernels with `lecun_normal`, which is `variance_scaling(1.0, "fan_in",
"truncated_normal")`: a standard normal truncated to (-2, 2), times
sqrt(1 / fan_in) / 0.87962566103423978 (the truncated normal's own std), so
the kernel's variance is 1 / fan_in. Their biases start at zero. fan_in is
taken on the flax kernel's layout, the product of every axis but the last:

  - Dense (in, out) = Linear weight (out, in):          in
  - Conv (kh, kw, in, out) = Conv2d weight (out, in, kh, kw): kh kw in
  - ConvTranspose4x4s2 (4, 4, in, out)
    = ConvTranspose2d weight (in, out, 4, 4):           16 in

(torch's own rule would take 16 out for the transposed convolution). The
geometry features are 0.01 N(0, 1) (NHWC in flax). BatchNorm keeps scale 1
and bias 0, as flax starts it.

The values are JAX's own, not only its distribution: which draw a seed
gives decides the campaign's first epoch (ROADMAP F20, open: from
PRNGKey(0)'s draw the decoder's scales shrink in epoch 1 as JAX's do and
the footprint goes to M=4 at the epoch-1 retune; from six other draws of
the same distribution it stayed at M=9). So the stream is reproduced:

  - the key: JAX's Threefry-2x32 (`threefry2x32`), PRNGKey(seed) = [0,
    seed mod 2**32] (JAX's with 64-bit types off, as the JAX package runs);
    a flax parameter's key is `fold_in(PRNGKey(seed), h)`, h the
    first 4 bytes (big-endian) of the SHA-1 of its scope's path names and
    the scope's draw counter (1 for a kernel, the first parameter of its
    module; 1 for geo_feature, the first of the root's), as flax's
    `Scope.make_rng` and `_fold_in_static` fold them (flax's default
    without separators);
  - the bits: JAX's partitionable stream, element i (row-major over the
    flax shape) = x0 ^ x1 of Threefry(key, (i >> 32, i & 0xffffffff));
  - `uniform`, `truncated_normal` and `normal` as `jax.random` forms them
    in float32 (the uniform's scale and shift rounded once, as XLA's fused
    multiply-add on the CPU does), with the inverse error function in
    float64, rounded (XLA's float32 one may differ by an ulp or two).

Every draw is made on the CPU in numpy, so one seed gives the same state
on any device; `tests/test_torch_init.py` holds it against JAX's
`init_state` leaf for leaf. A parameter's flax path comes from
`bridge.port_key`, inverted over the paths the JAX modules use.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

# std of a standard normal truncated to (-2, 2): flax divides by it
TRUNC_STD = 0.87962566103423978
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = np.float32


def flax_fan_in(module: nn.Module) -> int:
    """fan_in of a Linear, Conv2d or ConvTranspose2d weight on the flax
    kernel's layout."""
    w = module.weight
    if isinstance(module, nn.Linear):
        return w.shape[1]
    if isinstance(module, nn.ConvTranspose2d):
        return w.shape[0] * w.shape[2] * w.shape[3]
    if isinstance(module, nn.Conv2d):
        return w.shape[1] * w.shape[2] * w.shape[3]
    raise TypeError(f"no flax kernel layout for {type(module).__name__}")


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """JAX's Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1),
    uint32 arrays, under the key pair `key`."""
    with np.errstate(over="ignore"):
        k = [np.uint32(key[0]), np.uint32(key[1])]
        k.append(k[0] ^ k[1] ^ np.uint32(0x1BD11BDA))
        x0 = x0.astype(np.uint32) + k[0]
        x1 = x1.astype(np.uint32) + k[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x0 ^ x1
            x0 = x0 + k[(i + 1) % 3]
            x1 = x1 + k[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) as the JAX package makes it, with 64-bit
    types off: [0, the seed's low 32 bits] (a 64-bit seed such as torch's
    `initial_seed()` included; JAX itself refuses one of 2**63 or more)."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data) for a uint32 `data`."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def param_key(seed: int, scope: Tuple[str, ...], counter: int) -> np.ndarray:
    """The key flax draws the `counter`-th parameter of the scope at path
    `scope` with, under init(PRNGKey(seed))."""
    m = hashlib.sha1()
    for x in (*scope, counter):
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(prng_key(seed), int.from_bytes(m.digest()[:4], "big"))


def uniform(key: np.ndarray, shape, lo, hi) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, lo, hi)."""
    n = math.prod(shape)
    i = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    f = bits.view(_F32) - _F32(1.0)
    lo, hi = _F32(lo), _F32(hi)
    # f (hi - lo) + lo rounded once: XLA fuses it into a multiply-add
    scaled = (f.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(_F32)
    return np.maximum(lo, scaled).reshape(shape)


def _erfinv(u: np.ndarray) -> np.ndarray:
    return torch.erfinv(torch.from_numpy(u.astype(np.float64))).numpy().astype(_F32)


def truncated_normal(key: np.ndarray, shape) -> np.ndarray:
    """jax.random.truncated_normal(key, -2, 2, shape, float32)."""
    sqrt2 = _F32(np.sqrt(2))
    lo = _F32(math.erf(float(_F32(-2.0) / sqrt2)))
    hi = _F32(math.erf(float(_F32(2.0) / sqrt2)))
    out = sqrt2 * _erfinv(uniform(key, shape, lo, hi))
    return np.clip(out, np.nextafter(_F32(-2.0), _F32(np.inf)),
                   np.nextafter(_F32(2.0), _F32(-np.inf)))


def normal(key: np.ndarray, shape) -> np.ndarray:
    """jax.random.normal(key, shape, float32)."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    return _F32(np.sqrt(2)) * _erfinv(uniform(key, shape, lo, 1.0))


def lecun_normal(key: np.ndarray, shape) -> np.ndarray:
    """flax's lecun_normal()(key, shape) on the flax kernel's shape."""
    std = np.sqrt(_F32(1.0 / math.prod(shape[:-1]))) / _F32(TRUNC_STD)
    return truncated_normal(key, shape) * std


def _flax_shape(path: Tuple[str, ...], weight: torch.Tensor) -> Tuple[int, ...]:
    """A kernel's shape on the flax layout (bridge.to_port's inverse)."""
    s = tuple(weight.shape)
    if len(s) == 2:
        return s[1], s[0]
    if path[-2].startswith("ConvTranspose4x4s2_"):
        return s[2], s[3], s[0], s[1]
    return s[2], s[3], s[1], s[0]


def flax_paths(net: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """Every parameter of an AvatarNet -> its flax leaf path
    (bridge.port_key inverted over the paths the JAX modules use; an
    UpConv2DBlock's conv is ConvTranspose4x4s2_0 or, upsampling, Conv_0,
    as its module is)."""
    from gaussianavatar_torch import bridge

    mods = dict(net.named_modules())
    names = dict(net.named_parameters())
    found: Dict[str, list] = {}

    def add(path):
        try:
            key = bridge.port_key(path)
        except (NotImplementedError, KeyError):
            return
        if key in names:
            found.setdefault(key, []).append(path)

    for path in (("geo_feature",), ("pose_embedding",), ("transl_embedding",)):
        add(path)
    for i in range(16):
        for leaf in ("kernel", "bias", "scale"):
            for sub, layers in (("ShapeDecoder_0", ("Dense", "BatchNorm")),
                                ("GeomConvLayers_0", ("Conv",)),
                                ("GeomConvBottleneckLayers_0", ("Conv", "ConvTranspose4x4s2"))):
                for layer in layers:
                    add(("pop", sub, f"{layer}_{i}", leaf))
            for block in (f"Conv2DBlock_{i}", f"UpConv2DBlock_{i}"):
                for layer in ("Conv_0", "ConvTranspose4x4s2_0", "BatchNorm_0"):
                    add(("pose_encoder", block, layer, leaf))
                    add(("pop", "UnetNoCond5DS_0", block, layer, leaf))
    out = {}
    for key in names:
        paths = found.get(key)
        if not paths:
            raise NotImplementedError(f"no flax path for {key}")
        if len(paths) > 1:
            transposed = isinstance(mods[key.rsplit(".", 1)[0]], nn.ConvTranspose2d)
            paths = [p for p in paths if p[-2].startswith("ConvTranspose4x4s2_") == transposed]
        out[key] = paths[0]
    return out


@torch.no_grad()
def init_like_flax(net: nn.Module, seed: int) -> nn.Module:
    """Set an AvatarNet's parameters to the JAX package's `init_state(...,
    rng=PRNGKey(seed))`: every kernel and the geometry features drawn as
    flax draws them, biases zero (BatchNorm and the embeddings keep what
    the modules were built with: scale 1, bias 0, the initial poses)."""
    from gaussianavatar_torch import bridge

    params = dict(net.named_parameters())
    for key, path in flax_paths(net).items():
        p = params[key]
        if path[-1] == "kernel":
            value = lecun_normal(param_key(seed, path[:-1], 1), _flax_shape(path, p))
        elif path == ("geo_feature",):
            _, C, F, _ = p.shape
            value = 0.01 * normal(param_key(seed, (), 1), (1, F, F, C))
        elif path[-1] == "bias":
            value = np.zeros(tuple(p.shape), _F32)
        else:
            continue
        p.copy_(bridge.to_port(path, value).to(p.device))
    return net
