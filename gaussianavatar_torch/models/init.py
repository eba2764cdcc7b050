"""The initial weights of the JAX package's flax modules, drawn in torch.

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
draws come from an explicit CPU generator, so one seed gives the same
weights wherever the module is moved afterwards. BatchNorm keeps scale 1
and bias 0, as flax starts it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# std of a standard normal truncated to (-2, 2): flax divides by it
TRUNC_STD = 0.87962566103423978


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


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Redraw every Linear, Conv2d and ConvTranspose2d under `module` (in
    `module.modules()` order) as flax's lecun_normal, biases zero, from
    `generator` (None: torch's default one). The module's parameters must
    lie on the generator's device (the CPU)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
            m.weight.mul_(math.sqrt(1.0 / flax_fan_in(m)) / TRUNC_STD)
            if m.bias is not None:
                m.bias.zero_()
    return module
