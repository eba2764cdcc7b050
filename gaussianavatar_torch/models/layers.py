"""Building blocks (counterpart of gaussianavatar_tpu/models/layers.py, the
stage-1 part: `Conv2DBlock`, `GeomConvLayers`), plus the flax-semantics
BatchNorm that every BN layer of the port uses.

Layout is NCHW (PyTorch's); the JAX package is NHWC. `bridge.py` converts
HWIO conv kernels to OIHW. Flax convolutions are cross-correlations like
torch's, so no kernel flip is needed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
    torch.no_grad leaves them as they are."""

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
            mean = xf.mean(dim=axes)
            # jnp.maximum, as flax: an even split of the gradient at a tie
            var = torch.maximum((xf * xf).mean(dim=axes) - mean * mean, torch.zeros_like(mean))
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
