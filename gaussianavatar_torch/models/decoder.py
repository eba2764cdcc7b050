"""ShapeDecoder, the POP per-point MLP head (counterpart of
gaussianavatar_tpu/models/decoder.py `ShapeDecoder`), and
ShapeDecoderFused, the same network with every Dense -> BatchNorm ->
activation stage folded into one pass (`ShapeDecoderFused` there).

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

from gaussianavatar_torch.models.layers import BN_EPS, BN_MOMENTUM, FlaxBatchNorm
from gaussianavatar_torch.ops.decoder_stage import ColumnStats, FusedStage, softplus
from gaussianavatar_torch.parallel import mesh


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


class ShapeDecoderFused(ShapeDecoder):
    """ShapeDecoder with each Dense -> BatchNorm -> activation stage fused
    (gaussianavatar_tpu/models/decoder.py:199-222), on the three kernels of
    ops/decoder_stage.py.

    With m = mean(x) and S = x^T x / R over the stage's input x (R, C),
    the pre-activation y = x W + b has E[y] = m W + b and
    var(y) = diag(W^T S W) + 2 b (m W) + b^2 - E[y]^2, so the batch
    statistics come from H-dstat's column sums and Gram, never from a
    materialised y. BatchNorm then folds into the Dense as a column scale
    of W and a bias shift (in float32, cast to the compute dtype), and
    H-dfwd applies the activation in the product's epilogue; H-dbwd rebuilds
    the activation's derivative from its output. In eval mode the running
    statistics take the place of the batch's. x5 feeds three stages: its
    statistics are taken once (9 H-dstat launches per training decode, 11
    H-dfwd). The heads are plain products, as in ShapeDecoder.

    The submodules, parameters and buffers are ShapeDecoder's, so the two
    state_dicts are identical and checkpoints load either way. Running
    statistics move as FlaxBatchNorm moves them (momentum 0.9, in training
    mode with autograd on), and inside a data-parallel group a training
    call with autograd on takes the global batch's [sum x, x^T x, count]
    through `mesh.global_sum`, one call per distinct input in network order."""

    def __init__(self, in_size: int, hsize: int = 128, actv_fn: str = "softplus",
                 compute_dtype: str = "float32"):
        super().__init__(in_size, hsize, actv_fn, compute_dtype)
        self.act = "relu" if actv_fn == "relu" else "softplus"

    def _stats(self, x: torch.Tensor):
        """(m, S) of x's rows in training mode, else None."""
        if not self.training:
            return None
        C = x.shape[-1]
        colsum, gram = ColumnStats.apply(x.reshape(-1, C))
        n = x.numel() // C
        if mesh.syncs_batch_stats() and torch.is_grad_enabled():
            sums = mesh.global_sum(torch.cat([colsum, gram.reshape(-1), colsum.new_tensor([n])]))
            colsum, gram, n = sums[:C], sums[C:C + C * C].reshape(C, C), sums[-1]
        return colsum / n, gram / n

    def _fused(self, i: int, j: int, x: torch.Tensor, stats=None) -> torch.Tensor:
        lin, bn = self.dense[i], self.bn[j]
        W, b = lin.weight.t(), lin.bias
        if stats is not None:
            m, S = stats
            mw = m @ W
            mu = mw + b
            e2 = (W * (S @ W)).sum(0) + 2.0 * b * mw + b * b
            # jnp.maximum, as the JAX stage: an even split of the gradient at a tie
            var = torch.maximum(e2 - mu * mu, torch.zeros_like(mu))
            if torch.is_grad_enabled():
                with torch.no_grad():
                    bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mu)
                    bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        else:
            mu, var = bn.running_mean, bn.running_var
        s = bn.weight * torch.rsqrt(var + BN_EPS)
        Wp = (W * s).to(self.cdt).contiguous()
        bp = ((b - mu) * s + bn.bias).to(self.cdt)
        C = x.shape[-1]
        z = FusedStage.apply(x.reshape(-1, C).contiguous(), Wp, bp, self.act)
        return z.reshape(*x.shape[:-1], -1)

    def _stage(self, i: int, j: int, x: torch.Tensor) -> torch.Tensor:
        return self._fused(i, j, x, self._stats(x))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, N, in_size) -> (xyz (B,N,3), scales (B,N,1), shs (B,N,3)), f32."""
        x1 = self._stage(0, 0, x)
        x2 = self._stage(1, 1, x1)
        x3 = self._stage(2, 2, x2)
        x4 = self._stage(3, 3, x3)
        x5 = self._stage(4, 4, torch.cat([x.to(self.cdt), x4], dim=-1))
        st5 = self._stats(x5)

        x6 = self._fused(5, 5, x5, st5)
        x7 = self._stage(6, 6, x6)
        xyz = self._dense(7, x7).float()

        n6 = self._fused(8, 7, x5, st5)
        n7 = self._stage(9, 8, n6)
        scales = torch.sigmoid(self._dense(10, n7).float())

        s6 = self._fused(11, 9, x5, st5)
        s7 = self._stage(12, 10, s6)
        shs = torch.sigmoid(self._dense(13, s7).float())
        return xyz, scales, shs
