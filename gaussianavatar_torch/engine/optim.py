"""Optimizers with the JAX package's training dynamics (counterpart of
gaussianavatar_tpu/engine/optim.py), written out so that every update is the
optax / JAX expression in the same order:

  - `multistep_schedule`: MultiStepLR(gamma=0.1), read at the update count
    BEFORE the update (optax's `scale_by_schedule`). With
    `sched_unit == "iteration"` the milestones count iterations although the
    reference names them in epochs, so the rate drops after 66 and 133 steps
    (the reference steps its scheduler every iteration).
  - `Adam`: optax.adam (eps outside the square root of the bias-corrected
    second moment, one update count per group).
  - `SparseAdam`: the JAX package's sparse_adam for the embedding tables on
    dense gradients: a row is touched when any entry of its gradient is
    nonzero; only touched rows update their moments and values; untouched
    moments go stale; the shared step advances only when some row of the
    group was touched. (torch.optim.SparseAdam keys on sparse indices
    instead.)
  - `build_optimizer`: the stage-1 groups, net Adam at lr_net (3e-3), geo
    Adam at lr_geomfeat (5e-4), embeddings SparseAdam at lr_pose (5e-3).

Moments and counts stay on the parameters' device; nothing here waits for
the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence

import numpy as np
import torch
from torch import nn

B1, B2, EPS = 0.9, 0.999, 1e-8


def multistep_schedule(base_lr: float, milestones: Sequence[int],
                       gamma: float = 0.1) -> Callable[[int], np.float32]:
    """count -> base_lr * gamma ** (milestones passed), in float32 as JAX
    computes it."""
    ms = sorted(int(m) for m in milestones)

    def fn(count: int) -> np.float32:
        n = sum(count >= m for m in ms)
        return np.float32(base_lr) * np.power(np.float32(gamma), np.float32(n))

    return fn


class Adam:
    """optax.adam(learning_rate=lr_fn) over one group of parameters."""

    def __init__(self, params: Iterable[nn.Parameter], lr_fn: Callable[[int], float]):
        self.params = list(params)
        self.lr_fn = lr_fn
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        # float32 scalars, as JAX forms them; a Python float that holds a
        # float32 value enters a float32 tensor op unchanged
        step_size = float(-self.lr_fn(self.count))
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(B1) ** f32(self.count))
        bc2 = float(f32(1) - f32(B2) ** f32(self.count))
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g * g) + B2 * nu)
            p.add_(step_size * ((mu / bc1) / (torch.sqrt(nu / bc2) + EPS)))


class SparseAdam:
    """The JAX package's sparse_adam (constant rate) over embedding tables
    whose gradients are dense with zero rows."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float):
        self.params = list(params)
        self.lr = lr
        self.step_count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        masks = [(g != 0).any(dim=-1, keepdim=True) for g in grads]
        any_touch = torch.stack([m.any() for m in masks]).any()
        self.step_count += any_touch.to(torch.int32)
        sf = self.step_count.to(torch.float32)
        c1 = torch.clamp_min(1.0 - B1 ** sf, 1e-12)
        c2 = torch.clamp_min(1.0 - B2 ** sf, 1e-12)
        for p, g, mask, mu, nu in zip(self.params, grads, masks, self.mu, self.nu):
            mu.copy_(torch.where(mask, B1 * mu + (1 - B1) * g, mu))
            nu.copy_(torch.where(mask, B2 * nu + (1 - B2) * g * g, nu))
            upd = -self.lr * (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            p.add_(torch.where(mask, upd, torch.zeros_like(upd)))


class GroupOptimizer:
    """The optimizer groups of one stage, stepped together."""

    def __init__(self, groups: Dict[str, object]):
        self.groups = groups

    def step(self):
        for opt in self.groups.values():
            opt.step()

    def zero_grad(self):
        for opt in self.groups.values():
            for p in opt.params:
                p.grad = None


def param_group(name: str) -> str:
    """Optimizer group of an AvatarNet parameter name."""
    if name == "geo_feature":
        return "geo"
    if name in ("pose_embedding", "transl_embedding"):
        return "embed"
    return "net"


def build_optimizer(net: nn.Module, opt_cfg, steps_per_epoch: int,
                    train_stage: int = 1) -> GroupOptimizer:
    """The stage-1 groups of AvatarModel.training_setup."""
    if train_stage != 1:
        raise NotImplementedError("the stage-2 optimizer groups are not ported yet (stage 2 "
                                  "is a later slice of the port)")
    unit = getattr(opt_cfg, "sched_unit", "iteration")
    ms = [int(m) * (steps_per_epoch if unit == "epoch" else 1) for m in opt_cfg.sched_milestones]
    named = {"net": [], "geo": [], "embed": []}
    for name, p in net.named_parameters():
        named[param_group(name)].append(p)
    return GroupOptimizer({
        "net": Adam(named["net"], multistep_schedule(opt_cfg.lr_net, ms)),
        "geo": Adam(named["geo"], multistep_schedule(opt_cfg.lr_geomfeat, ms)),
        "embed": SparseAdam(named["embed"], getattr(opt_cfg, "lr_pose", 5e-3)),
    })
