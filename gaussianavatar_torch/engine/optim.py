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
the device. Each optimizer's `state_dict()` holds its update count and its
moments keyed by the parameters' names in the network's `state_dict`, so a
checkpoint resumes training where it stopped (engine/checkpoint.py) and
bridge.py maps the moments to and from the optax state.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

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


class _Moments:
    """First and second moments of named parameters, zero at the start."""

    def __init__(self, params: Dict[str, nn.Parameter]):
        self.names = list(params)
        self.params = list(params.values())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _moments_state(self) -> dict:
        return {"mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def _load_moments(self, state: dict):
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.names):
                raise KeyError(f"{key} names {sorted(state[key])} != the group's {self.names}")
            for name, dst in zip(self.names, getattr(self, key)):
                dst.copy_(torch.as_tensor(state[key][name]))


class Adam(_Moments):
    """optax.adam(learning_rate=lr_fn) over one group of named parameters."""

    def __init__(self, params: Dict[str, nn.Parameter], lr_fn: Callable[[int], float]):
        super().__init__(params)
        self.lr_fn = lr_fn
        self.count = 0

    def state_dict(self) -> dict:
        return {"count": self.count, **self._moments_state()}

    def load_state_dict(self, state: dict):
        self._load_moments(state)
        self.count = int(state["count"])

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


class SparseAdam(_Moments):
    """The JAX package's sparse_adam (constant rate) over embedding tables
    whose gradients are dense with zero rows."""

    def __init__(self, params: Dict[str, nn.Parameter], lr: float):
        super().__init__(params)
        self.lr = lr
        self.step_count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)

    def state_dict(self) -> dict:
        return {"step_count": self.step_count, **self._moments_state()}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self._load_moments(state)
        self.step_count.copy_(torch.as_tensor(state["step_count"]))

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

    def state_dict(self) -> dict:
        """{group: that optimizer's state_dict}; the tensors are the live
        moments, not copies."""
        return {name: opt.state_dict() for name, opt in self.groups.items()}

    def load_state_dict(self, state: dict):
        if set(state) != set(self.groups):
            raise KeyError(f"optimizer groups {sorted(state)} != {sorted(self.groups)}")
        for name, opt in self.groups.items():
            opt.load_state_dict(state[name])


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
    named = {"net": {}, "geo": {}, "embed": {}}
    for name, p in net.named_parameters():
        named[param_group(name)][name] = p
    return GroupOptimizer({
        "net": Adam(named["net"], multistep_schedule(opt_cfg.lr_net, ms)),
        "geo": Adam(named["geo"], multistep_schedule(opt_cfg.lr_geomfeat, ms)),
        "embed": SparseAdam(named["embed"], getattr(opt_cfg, "lr_pose", 5e-3)),
    })
