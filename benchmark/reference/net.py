"""The plain reference's network: GaussianAvatar's POP decoder (the
geometry-feature smoother of three 5x5 convolutions, the bilinear upsample
to the query resolution, the gather of the valid UV pixels, the 14-layer
ShapeDecoder with BatchNorm and softplus and its three heads) and the
stage-2 UNet pose encoder, written as functions of a dict of tensors.

The dict's keys are the names the benchmark draws its weights under
(`param_specs`); the program's module tree uses the same names, so one set
of weights is handed to both sides. BatchNorm takes the batch's statistics
(training) or the initial running statistics, mean 0 and variance 1 (eval),
with flax's arithmetic: biased variance, eps 1e-5.

Precision: float32 throughout, with TF32 off (the caller sets the torch
switches). `q`, where given, rounds the decoder's matmul operands, biases
and activations, and their gradients, to a lower precision (`rounding`):
the control of the correctness check.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
# the ShapeDecoder's layers: input widths as multiples of (in, h), outputs
_DENSE_IN = ["in", "h", "h", "h", "in+h", "h", "h", "h", "h", "h", "h", "h", "h", "h"]
_DENSE_OUT = ["h", "h", "h", "h", "h", "h", "h", 3, "h", "h", 1, "h", "h", 3]
N_BN = 11
# UNet5DS: down and up widths in multiples of nf
_UNET_DOWN = (1, 2, 4, 8, 8)
_UNET_UP = (8, 4, 2, 1)


def dense_shapes(in_size: int, h: int) -> List[Tuple[int, int]]:
    """(in, out) of the ShapeDecoder's 14 dense layers."""
    w = lambda s: {"in": in_size, "h": h, "in+h": in_size + h}.get(s, s)
    return [(w(i), w(o)) for i, o in zip(_DENSE_IN, _DENSE_OUT)]


def unet_shapes(c_in: int, c_out: int, nf: int):
    """-> (down convs [(cin, cout)], up transposed convs [(cin, cout)])."""
    chans = [c_in] + [m * nf for m in _UNET_DOWN]
    n = len(_UNET_DOWN)
    downs = [(chans[i], chans[i + 1]) for i in range(n)]
    outs = [m * nf for m in _UNET_UP] + [c_out]
    ins = [chans[n]] + [outs[i] + chans[n - 1 - i] for i in range(n - 1)]
    return downs, list(zip(ins, outs))


class _Round(torch.autograd.Function):
    """`cast` on the value going forward and on its gradient going back."""

    @staticmethod
    def forward(ctx, t, cast):
        ctx.cast = cast
        return cast(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.cast(g), None


def _cast(dtype: torch.dtype, scaled: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """-> t rounded to `dtype` and back; `scaled` scales each tensor by its
    largest magnitude onto the format's range first (per-tensor scaling,
    without which float8 gradients underflow). An integer `dtype` is
    symmetric per-tensor quantization."""
    if dtype == torch.int8:
        def cast(t):
            s = 127.0 / torch.clamp_min(t.detach().abs().amax(), 1e-30)
            return torch.round(t * s).clamp(-127, 127) / s
        return cast
    top = float(torch.finfo(dtype).max)

    def cast(t):
        if not scaled:
            return t.to(dtype).to(t.dtype)
        s = top / torch.clamp_min(t.detach().abs().amax(), 1e-30)
        return (t * s).clamp(-top, top).to(dtype).to(t.dtype) / s

    return cast


def rounding(dtype: torch.dtype, scaled: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """-> q(t): t rounded to `dtype` and back going forward, and its
    gradient going back, so that each matmul of the decoder takes rounded
    operands both ways and sums in float32, as a tensor-core matmul of that
    precision does."""
    cast = _cast(dtype, scaled)
    return lambda t: _Round.apply(t, cast)


# the precisions below the configurations' bfloat16 decoder, both ways,
# each tensor scaled by its largest magnitude: the controls of the
# correctness check, int8 for training (float8's rounding averages out of
# the gradients' norms) and float8 e4m3 for rendering (per-tensor int8
# keeps more bits of the decoder's forward), each read beside the other
int8 = rounding(torch.int8, scaled=True)
fp8 = rounding(torch.float8_e4m3fn, scaled=True)
# the configurations' own decoder precision, for the look at what rounding
# alone moves (benchmark/tools/readings.py)
bf16 = rounding(torch.bfloat16, scaled=False)


def param_specs(c: dict, n_frames: int, pose_dim: int) -> Dict[str, Tuple[tuple, str]]:
    """name -> (shape, how it starts) for the configuration `c`:
    'lecun:<fan_in>' (N(0, 1/fan_in)), 'zeros', 'ones', 'geo' (0.01 N(0, 1)),
    'pose' / 'transl' (the frames' own, from the inputs) or 'const:<v>'. The
    scale head's bias is logit(c['init_scale']): the avatar's gaussians
    start at about that size (metres) instead of sigmoid(0) = 0.5."""
    C, h, F_ = c["c_geom"], c["hsize"], c["inp_posmap_size"]
    s = {"geo_feature": ((1, C, F_, F_), "geo"),
         "pose_embedding": ((n_frames, pose_dim), "pose"),
         "transl_embedding": ((n_frames, 3), "transl")}
    for i in range(3):
        s[f"pop.geom.convs.{i}.weight"] = ((C, C, 5, 5), f"lecun:{C * 25}")
    for i, (fi, fo) in enumerate(dense_shapes(C + 2, h)):
        s[f"pop.decoder.dense.{i}.weight"] = ((fo, fi), f"lecun:{fi}")
        s[f"pop.decoder.dense.{i}.bias"] = ((fo,), "zeros")
    p = c["init_scale"]
    s["pop.decoder.dense.10.bias"] = ((1,), f"const:{float(np.log(p / (1.0 - p)))!r}")
    for j in range(N_BN):
        s[f"pop.decoder.bn.{j}.weight"] = ((h,), "ones")
        s[f"pop.decoder.bn.{j}.bias"] = ((h,), "zeros")
    if c["train_stage"] == 2:
        downs, ups = unet_shapes(3, c["c_pose"], c["nf"])
        for i, (ci, co) in enumerate(downs):
            s[f"pose_encoder.down.{i}.conv.weight"] = ((co, ci, 4, 4), f"lecun:{ci * 16}")
        for i, (ci, co) in enumerate(ups):
            s[f"pose_encoder.up.{i}.conv.weight"] = ((ci, co, 4, 4), f"lecun:{ci * 16}")
        s[f"pose_encoder.up.{len(ups) - 1}.conv.bias"] = ((c["c_pose"],), "zeros")
    return s


def batch_norm(x: torch.Tensor, axes, train: bool, w=None, b=None) -> torch.Tensor:
    """flax BatchNorm in float32 over `axes`; eval takes mean 0, var 1."""
    if train:
        mean = x.mean(dim=axes, keepdim=True)
        var = torch.clamp_min((x * x).mean(dim=axes, keepdim=True) - mean * mean, 0.0)
    else:
        mean, var = torch.zeros((), device=x.device), torch.ones((), device=x.device)
    y = (x - mean) * torch.rsqrt(var + BN_EPS)
    if w is not None:
        y = y * w + b
    return y


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def shape_decoder(P: dict, x: torch.Tensor, train: bool,
                  q: Optional[Callable] = None) -> Tuple[torch.Tensor, ...]:
    """x (R, in) -> (offsets (R, 3), scales (R, 1), colours (R, 3)); the
    heads raw, sigmoid, sigmoid. BatchNorm over all R rows."""
    q = q or (lambda t: t)
    k = "pop.decoder."

    def dense(i, t):
        return q(q(t) @ q(P[f"{k}dense.{i}.weight"]).t() + q(P[f"{k}dense.{i}.bias"]))

    def stage(i, j, t):
        u = batch_norm(dense(i, t), 0, train, P[f"{k}bn.{j}.weight"], P[f"{k}bn.{j}.bias"])
        return q(softplus(q(u)))

    x1 = stage(0, 0, x)
    x2 = stage(1, 1, x1)
    x3 = stage(2, 2, x2)
    x4 = stage(3, 3, x3)
    x5 = stage(4, 4, torch.cat([q(x), x4], -1))
    xyz = dense(7, stage(6, 6, stage(5, 5, x5)))
    scales = torch.sigmoid(dense(10, stage(9, 8, stage(8, 7, x5))))
    shs = torch.sigmoid(dense(13, stage(12, 10, stage(11, 9, x5))))
    return xyz, scales, shs


def interp_matrix(out_res: int, in_res: int, device) -> torch.Tensor:
    """(out, in) bilinear weights at p_i = i / (out - 1) * in - 0.5, zero
    outside: grid_sample's align_corners=False sampling of the full UV
    image at the query grid."""
    pos = np.arange(out_res) / (out_res - 1) * in_res - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    W = np.zeros((out_res, in_res), np.float32)
    for side, wgt in ((lo, 1.0 - frac), (lo + 1, frac)):
        ok = (side >= 0) & (side < in_res)
        W[np.arange(out_res)[ok], side[ok]] += wgt[ok]
    return torch.as_tensor(W, device=device)


def unet(P: dict, x: torch.Tensor, train: bool, prefix: str = "pose_encoder.") -> torch.Tensor:
    """UNet5DS (NCHW): down blocks [leaky_relu 0.2] -> conv 4x4 s2 ->
    [BatchNorm], the first without activation and BatchNorm, the last
    without BatchNorm; up blocks relu -> transposed conv 4x4 s2 ->
    [BatchNorm] -> concatenate the mirrored down output; the last up block
    has a bias and no BatchNorm."""
    n = len(_UNET_DOWN)
    skips = []
    for i in range(n):
        if i > 0:
            x = F.leaky_relu(x, 0.2)
        x = F.conv2d(x, P[f"{prefix}down.{i}.conv.weight"], stride=2, padding=1)
        if 0 < i < n - 1:
            x = batch_norm(x, (0, 2, 3), train)
        skips.append(x)
    x = skips[-1]
    for i in range(n):
        x = F.conv_transpose2d(F.relu(x), P[f"{prefix}up.{i}.conv.weight"],
                               P.get(f"{prefix}up.{i}.conv.bias"), stride=2, padding=1)
        if i < n - 1:
            x = torch.cat([batch_norm(x, (0, 2, 3), train), skips[n - 2 - i]], 1)
    return x


def decode(P: dict, av, c: dict, train: bool, posmaps: Optional[torch.Tensor] = None,
           q: Optional[Callable] = None):
    """The POP decode of the avatar `av` (reference/body.Avatar): stage 1
    once (B = 1), stage 2 once per input posmap (B, 3, F, F) with the pose
    encoder's feature map added to the smoothed geometry features ->
    (offsets x 0.02 (B, Np, 3), scales (B, Np, 1), colours (B, Np, 3),
    pose feature map or None)."""
    B = 1 if posmaps is None else posmaps.shape[0]
    g = P["geo_feature"].expand(B, -1, -1, -1)
    for i in range(3):
        g = F.conv2d(g, P[f"pop.geom.convs.{i}.weight"], padding=2)
    pf = None
    if posmaps is not None:
        pf = unet(P, posmaps, train)
        g = g + pf
    R = av.res
    W = interp_matrix(R, g.shape[-1], g.device)
    up = torch.einsum("sg,bcrg->bcrs", W, torch.einsum("rf,bcfg->bcrg", W, g))
    pts = up.reshape(B, g.shape[1], R * R)[:, :, av.valid_idx].transpose(1, 2)
    x = torch.cat([pts, av.uv[None].expand(B, -1, -1)], -1)
    Np = x.shape[1]
    xyz, scales, shs = shape_decoder(P, x.reshape(B * Np, -1), train, q)
    shape = lambda t: t.reshape(B, Np, -1)
    return shape(xyz) * 0.02, shape(scales), shape(shs), pf
