"""ShapeDecoder, the POP per-point MLP head (counterpart of
gaussianavatar_tpu/models/decoder.py `ShapeDecoder`).

Eight pointwise layers with a DeepSDF-style input skip into layer 5,
BatchNorm (affine) + softplus after every hidden layer, and three heads:
xyz offsets (raw), isotropic scale (1 channel, sigmoid), rgb (3, sigmoid).
Points are channels-last (B, N, C), as in the JAX package.

bf16 mode (`compute_dtype="bfloat16"`, the default through
NetworkParams.bf16_decoder) runs the matmuls and the inter-layer
activations in bf16, as flax does with `dtype=bf16`: inputs, weights and
biases are cast to bf16 per call, BatchNorm normalises in float32 against
the float32 running statistics and casts back to bf16, and the heads
return float32. Parameters and statistics stay float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gaussianavatar_torch.models.layers import FlaxBatchNorm


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus's formula, logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)), so the f32 decoder matches the JAX one to the ulp."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


# flax names the layers Dense_0..13 and BatchNorm_0..10 in call order; the
# module lists keep that order, so bridge.py maps index to index
_N_BN = 11


class ShapeDecoder(nn.Module):
    def __init__(self, in_size: int, hsize: int = 128, actv_fn: str = "softplus",
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16", "bf16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.cdt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
        self.actv = F.relu if actv_fn == "relu" else softplus
        h = hsize
        ins = [in_size, h, h, h, in_size + h, h, h, h, h, h, h, h, h, h]
        outs = [h, h, h, h, h, h, h, 3, h, h, 1, h, h, 3]
        self.dense = nn.ModuleList(nn.Linear(i, o) for i, o in zip(ins, outs))
        self.bn = nn.ModuleList(FlaxBatchNorm(h) for _ in range(_N_BN))

    def _dense(self, i: int, x: torch.Tensor) -> torch.Tensor:
        lin = self.dense[i]
        return F.linear(x.to(self.cdt), lin.weight.to(self.cdt), lin.bias.to(self.cdt))

    def _stage(self, i: int, j: int, x: torch.Tensor) -> torch.Tensor:
        return self.actv(self.bn[j](self._dense(i, x)))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, N, in_size) -> (xyz (B,N,3), scales (B,N,1), shs (B,N,3)), f32."""
        x1 = self._stage(0, 0, x)
        x2 = self._stage(1, 1, x1)
        x3 = self._stage(2, 2, x2)
        x4 = self._stage(3, 3, x3)
        x5 = self._stage(4, 4, torch.cat([x.to(self.cdt), x4], dim=-1))

        x6 = self._stage(5, 5, x5)
        x7 = self._stage(6, 6, x6)
        xyz = self._dense(7, x7).float()

        n6 = self._stage(8, 7, x5)
        n7 = self._stage(9, 8, n6)
        scales = torch.sigmoid(self._dense(10, n7).float())

        s6 = self._stage(11, 9, x5)
        s7 = self._stage(12, 10, s6)
        shs = torch.sigmoid(self._dense(13, s7).float())
        return xyz, scales, shs
