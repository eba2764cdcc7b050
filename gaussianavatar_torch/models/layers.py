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


class FlaxBatchNorm(nn.Module):
    """BatchNorm at inference with flax's arithmetic:
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias, in float32, cast to
    the input's dtype. `feature_dim` is the channel axis (1 for NCHW, -1 for
    channels-last points). Running statistics are buffers, kept in float32;
    training-mode statistics (flax: biased variance, momentum 0.9) come with
    the training slice, so a module in training mode refuses to run."""

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
        if self.training:
            raise NotImplementedError(
                "FlaxBatchNorm runs at inference only (call .eval()); batch "
                "statistics come with the training slice")
        shape = [1] * x.dim()
        shape[self.feature_dim] = -1
        mul = torch.rsqrt(self.running_var + BN_EPS)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x.float() - self.running_mean.reshape(shape)) * mul.reshape(shape)
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
