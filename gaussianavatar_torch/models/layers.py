"""Building blocks (counterpart of gaussianavatar_tpu/models/layers.py):
`Conv2DBlock`, `GeomConvLayers`, the stage-2 UNets (`UnetNoCond5DS`,
`UnetNoCond6DS`, `UnetNoCond7DS`) with their `UpConv2DBlock` and
`ConvTranspose4x4s2`, and `GeomConvBottleneckLayers`, plus the
flax-semantics BatchNorm that every BN layer of the port uses.

Layout is NCHW (PyTorch's); the JAX package is NHWC. `bridge.py` converts
HWIO conv kernels to OIHW. Flax convolutions are cross-correlations like
torch's, so no kernel flip is needed there; the JAX `ConvTranspose4x4s2`
stores its kernel for an input-dilated correlation, which is
`nn.ConvTranspose2d` with the taps flipped, and bridge.py flips them.

Each module takes its input channel count, which flax infers; the UNets'
skip concatenations order channels as the JAX package does (the upsampled
features first, then the skip).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gaussianavatar_torch.parallel import mesh

BN_EPS = 1e-5  # flax BatchNorm epsilon as the JAX package sets it


BN_MOMENTUM = 0.9  # flax: ra = momentum * ra + (1 - momentum) * batch


class FlaxBatchNorm(nn.Module):
    """BatchNorm with flax's arithmetic:
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias, in float32, cast to
    the input's dtype. `feature_dim` is the channel axis (1 for NCHW, -1 for
    channels-last points). Running statistics are buffers, kept in float32.

    In training mode it normalises with the batch statistics as flax takes
    them (float32 mean and the biased variance max(0, E[x^2] - E[x]^2) over
    every axis but the features) and, unless autograd is off, moves the
    running statistics by flax's rule with momentum 0.9 (torch.nn.BatchNorm
    would use momentum 0.1 and the unbiased variance). A render under
    torch.no_grad leaves them as they are.

    Inside a data-parallel group (parallel/mesh.py) a training call with
    autograd on takes the statistics of the global batch: every channel's
    sum, sum of squares and count, summed over the ranks by an all-reduce
    whose backward sums the statistics' gradient over the ranks."""

    def __init__(self, num_features: int, affine: bool = True, feature_dim: int = -1):
        super().__init__()
        self.feature_dim = feature_dim
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[self.feature_dim] = -1
        xf = x.float()
        if self.training:
            axes = [d for d in range(x.dim()) if d != self.feature_dim % x.dim()]
            if mesh.syncs_batch_stats() and torch.is_grad_enabled():
                # the global batch's statistics: each channel's sum, sum of
                # squares and count over every rank
                C = xf.shape[self.feature_dim]
                n = xf.new_tensor([xf.numel() / C])
                sums = mesh.global_sum(torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes), n]))
                mean, mean2 = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
            else:
                mean, mean2 = xf.mean(dim=axes), (xf * xf).mean(dim=axes)
            # jnp.maximum, as flax: an even split of the gradient at a tie
            var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
            if torch.is_grad_enabled():
                with torch.no_grad():
                    self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                    self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y.to(x.dtype)


class Conv2DBlock(nn.Module):
    """[LeakyReLU(0.2)] -> Conv(k, s, p) -> [BatchNorm(affine=False)]
    (the activation comes first)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, use_bias: bool = False,
                 use_bn: bool = True, use_relu: bool = True):
        super().__init__()
        self.use_relu = use_relu
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride, padding,
                              bias=use_bias)
        self.bn = FlaxBatchNorm(features, affine=False, feature_dim=1) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_relu:
            x = F.leaky_relu(x, 0.2)
        x = self.conv(x)
        return self.bn(x) if self.bn is not None else x


class ConvTranspose4x4s2(nn.ConvTranspose2d):
    """ConvTranspose2d(k=4, s=2, p=1): an exact 2x upsampler."""

    def __init__(self, in_channels: int, features: int, use_bias: bool = False):
        super().__init__(in_channels, features, 4, stride=2, padding=1, bias=use_bias)


class UpConv2DBlock(nn.Module):
    """ReLU -> upconv (`ConvTranspose4x4s2`) or upsample (bilinear 2x,
    half-pixel centres, then conv3x3 with bias) -> [BatchNorm(affine=False)]
    -> [Dropout(0.5), from `generator`] -> concatenate the skip input."""

    def __init__(self, in_channels: int, features: int, use_bias: bool = False,
                 use_bn: bool = True, up_mode: str = "upconv", use_dropout: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.up_mode = up_mode
        self.use_dropout = use_dropout
        self.generator = generator
        if up_mode == "upconv":
            self.conv = ConvTranspose4x4s2(in_channels, features, use_bias=use_bias)
        else:
            self.conv = nn.Conv2d(in_channels, features, 3, padding=1, bias=True)
        self.bn = FlaxBatchNorm(features, affine=False, feature_dim=1) if use_bn else None

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.relu(x)
        if self.up_mode != "upconv":
            # jax.image.resize "bilinear" at 2x: half-pixel centres, no antialias
            # (it only matters when shrinking)
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.use_dropout and self.training:
            g = self.generator
            keep = torch.rand(x.shape, generator=g,
                              device=g.device if g is not None else x.device).to(x.device) >= 0.5
            x = torch.where(keep, x / 0.5, torch.zeros_like(x))
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return x


class GeomConvLayers(nn.Module):
    """3x conv5x5 (stride 1, pad 2, no bias) geometric feature smoother."""

    def __init__(self, in_channels: int, hidden_nc: int = 64, output_nc: int = 64,
                 use_relu: bool = False):
        super().__init__()
        self.use_relu = use_relu
        chans = [in_channels, hidden_nc, hidden_nc, output_nc]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 5, padding=2, bias=False) for i in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.use_relu and i < 2:
                x = F.leaky_relu(x, 0.2)
        return x


class GeomConvBottleneckLayers(nn.Module):
    """Bottleneck smoother: three stride-2 conv4x4 down (no bias), three
    `ConvTranspose4x4s2` up."""

    def __init__(self, in_channels: int, hidden_nc: int = 64, output_nc: int = 64):
        super().__init__()
        h = hidden_nc
        downs = [in_channels, h, 2 * h, 4 * h]
        self.down = nn.ModuleList(
            nn.Conv2d(downs[i], downs[i + 1], 4, 2, 1, bias=False) for i in range(3))
        ups = [4 * h, 2 * h, h, output_nc]
        self.up = nn.ModuleList(ConvTranspose4x4s2(ups[i], ups[i + 1]) for i in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in (*self.down, *self.up):
            x = layer(x)
        return x


class _UnetNoCond(nn.Module):
    """A UNet without conditioning: `len(down)` Conv2DBlocks (the first
    without activation or BatchNorm, the last without BatchNorm), then
    UpConv2DBlocks that each concatenate the mirrored down block's output;
    the last one has no BatchNorm and a bias. `down` and `up` list the
    output channels in multiples of nf, `up_modes` each up block's mode
    (None: the model's `up_mode`), `dropout` the up blocks with dropout."""

    def __init__(self, in_channels: int, output_nc: int, nf: int, up_mode: str,
                 use_dropout: bool, down: Sequence[int], up: Sequence[int],
                 up_modes: Sequence[Optional[str]], dropout: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = len(down)
        chans = [in_channels] + [m * nf for m in down]
        self.down = nn.ModuleList(
            Conv2DBlock(chans[i], chans[i + 1], use_bias=False, use_bn=0 < i < n - 1,
                        use_relu=i > 0)
            for i in range(n))
        outs = [m * nf for m in up] + [output_nc]
        ins = [chans[n]] + [outs[i] + chans[n - 1 - i] for i in range(n - 1)]
        last = n - 1
        self.up = nn.ModuleList(
            UpConv2DBlock(ins[i], outs[i], use_bias=i == last, use_bn=i != last,
                          up_mode=up_modes[i] or up_mode,
                          use_dropout=use_dropout and i in dropout, generator=generator)
            for i in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
        n = len(self.down)
        x = skips[-1]
        for i, block in enumerate(self.up):
            x = block(x, skips[n - 2 - i] if i < n - 1 else None)
        return x


class UnetNoCond5DS(_UnetNoCond):
    """Five-downsample UNet: the stage-2 pose encoder and the 'unet'
    geometry smoother."""

    def __init__(self, in_channels: int, output_nc: int = 3, nf: int = 64,
                 up_mode: str = "upconv", use_dropout: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, output_nc, nf, up_mode, use_dropout,
                         down=(1, 2, 4, 8, 8), up=(8, 4, 2, 1),
                         up_modes=(None,) * 5, dropout=(1, 2), generator=generator)


class UnetNoCond6DS(_UnetNoCond):
    """Six-downsample UNet; its last two up blocks upsample bilinearly."""

    def __init__(self, in_channels: int, output_nc: int = 3, nf: int = 64,
                 up_mode: str = "upconv", use_dropout: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, output_nc, nf, up_mode, use_dropout,
                         down=(1, 2, 4, 8, 8, 8), up=(8, 8, 8, 4, 2),
                         up_modes=(None,) * 4 + ("upsample",) * 2, dropout=(1, 2, 3),
                         generator=generator)


class UnetNoCond7DS(_UnetNoCond):
    """Seven-downsample UNet; its last three up blocks upsample bilinearly."""

    def __init__(self, in_channels: int, output_nc: int = 3, nf: int = 64,
                 up_mode: str = "upconv", use_dropout: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, output_nc, nf, up_mode, use_dropout,
                         down=(1, 2, 4, 8, 8, 8, 8), up=(8, 8, 8, 4, 2, 1),
                         up_modes=(None,) * 4 + ("upsample",) * 3, dropout=(1, 2, 3),
                         generator=generator)
