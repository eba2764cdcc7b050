"""Carry a stage-1 avatar's state between the JAX package's flax/optax trees
and the port, both ways.

Leaves are named by their path in the flax trees: ("pop", "ShapeDecoder_0",
"Dense_3", "kernel") in `params`, ("pop", "ShapeDecoder_0", "BatchNorm_3",
"mean") in `batch_stats`. `port_key` names the port's tensor for such a path
and `to_port` / `to_jax` change the layout:

  - Dense kernel (in, out)     <-> Linear weight (out, in); bias as is
  - Conv kernel HWIO           <-> Conv2d weight OIHW (both are correlations)
  - BatchNorm scale / bias     <-> weight / bias; batch_stats mean / var <->
                                   running_mean / running_var
  - geo_feature NHWC (1,F,F,C) <-> NCHW (1,C,F,F), the port's layout
  - pose_embedding, transl_embedding as they are.

An optimizer moment has its parameter's layout, so the same functions carry
the optax state: `multi_transform` over the groups net, geo, embed (and
pose_enc, empty in stage 1); net and geo are optax.adam (a ScaleByAdamState
count, mu and nu, and the schedule's count), embed the JAX package's
SparseAdamState (step, mu, nu). Every group's moment trees mirror the params
tree, with the other groups' leaves masked out.

  - `state_dict_from_jax(params, batch_stats)`: the port's AvatarNet
    `state_dict` (`geom_conv_state_dict`, `shape_decoder_state_dict`: of
    one POP submodule).
  - `train_state_from_jax(...)`: a JAX TrainState (params, batch_stats,
    iteration and, if given, the optax state's counts and moments) into the
    port's TrainState, so both packages train on from one state.
  - `jax_trees_from_port(net_sd, optimizer_sd, template)`: the inverse, into
    a JAX TrainState's trees built by the caller (`build_optimizer(...).init`
    for the optax state) and returned filled, as numpy.

Trees are nested dicts, tuples and NamedTuples of numpy arrays (e.g.
`jax.tree.map(np.asarray, state.opt_state)`); a leaf that is not an array
(optax's MaskedNode) is passed through. Only numpy and torch here: the
caller holds the JAX side.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gaussianavatar_torch.engine.train_step import TrainState

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_MOMENTS = ("mu", "nu")


def _index(name: str) -> int:
    return int(re.fullmatch(r"[A-Za-z]+_(\d+)", name).group(1))


def port_key(path: Sequence[str]) -> str:
    """The port's state_dict key of a flax params / batch_stats leaf path."""
    path = tuple(path)
    if path in (("geo_feature",), ("pose_embedding",), ("transl_embedding",)):
        return path[0]
    if len(path) == 4 and path[0] == "pop":
        sub, layer, leaf = path[1:]
        i = _index(layer)
        if sub == "GeomConvLayers_0" and layer.startswith("Conv_") and leaf == "kernel":
            return f"pop.geom.convs.{i}.weight"
        if sub == "ShapeDecoder_0" and layer.startswith("Dense_"):
            return f"pop.decoder.dense.{i}." + {"kernel": "weight", "bias": "bias"}[leaf]
        if sub == "ShapeDecoder_0" and layer.startswith("BatchNorm_"):
            return f"pop.decoder.bn.{i}.{_BN_LEAF[leaf]}"
    raise NotImplementedError(f"no port counterpart for flax leaf {'/'.join(path)} "
                              "(POP submodules other than GeomConvLayers and ShapeDecoder "
                              "are not ported yet)")


def _perm(path: Sequence[str], ndim: int):
    """The axis permutation from the flax layout to the port's, or None."""
    if path[0] == "geo_feature":
        return (0, 3, 1, 2)
    if path[-1] == "kernel":
        return (3, 2, 0, 1) if ndim == 4 else (1, 0)
    return None


def to_port(path: Sequence[str], a) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    perm = _perm(path, a.ndim)
    return torch.tensor(a if perm is None else a.transpose(perm))


def to_jax(path: Sequence[str], t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy().astype(np.float32)
    perm = _perm(path, a.ndim)
    return np.ascontiguousarray(a if perm is None else a.transpose(np.argsort(perm)))


def _leaves(tree, path=()):
    """(path, leaf) of every array leaf of nested dicts / tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (np.ndarray, np.generic)):
        yield path, tree


def _map(fn: Callable, tree, path=()):
    """`tree` with every array leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None)
        vals = [_map(fn, v, path + (k,)) for k, v in zip(names or range(len(tree)), tree)]
        return type(tree)(*vals) if names is not None else tuple(vals)
    if isinstance(tree, (np.ndarray, np.generic)):
        return fn(path, tree)
    return tree


def _opt_leaf(path: Tuple) -> Tuple[str, str, Tuple]:
    """An optax-state leaf path -> (group, "count" | "mu" | "nu", param path):
    ("inner_states", group, "inner_state", ..., "mu", *param path) or
    (..., "count" | "step")."""
    group = path[1]
    for i, k in enumerate(path):
        if k in _MOMENTS:
            return group, k, path[i + 1:]
    if path[-1] in ("count", "step"):
        return group, "count", ()
    raise ValueError(f"unexpected optax state leaf {path}")


def state_dict_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """The stage-1 AvatarNet's flax params + batch_stats -> its state_dict."""
    return {port_key(p): to_port(p, a)
            for tree in (params, batch_stats) for p, a in _leaves(tree)}


def _submodule_state_dict(sub: str, params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    prefix = {"GeomConvLayers_0": "pop.geom.", "ShapeDecoder_0": "pop.decoder."}[sub]
    sd = state_dict_from_jax({"pop": {sub: params}}, {"pop": {sub: batch_stats}})
    return {k[len(prefix):]: v for k, v in sd.items()}


def geom_conv_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """GeomConvLayers' flax params -> the port module's state_dict."""
    return _submodule_state_dict("GeomConvLayers_0", params, {})


def shape_decoder_state_dict(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """ShapeDecoder's flax params + batch_stats -> the port module's state_dict."""
    return _submodule_state_dict("ShapeDecoder_0", params, batch_stats)


def optimizer_state_from_jax(opt_state) -> dict:
    """The optax state of the stage-1 build_optimizer (numpy tree) -> the
    port's GroupOptimizer.state_dict() layout."""
    out = {g: {"mu": {}, "nu": {}} for g in ("net", "geo", "embed")}
    for path, a in _leaves(opt_state):
        group, kind, ppath = _opt_leaf(path)
        if group not in out:
            continue
        if kind == "count":
            # the embed group's SparseAdam keeps its step on the device
            out[group]["step_count" if group == "embed" else "count"] = (
                torch.tensor(int(a), dtype=torch.int32) if group == "embed" else int(a))
        else:
            out[group][kind][port_key(ppath)] = to_port(ppath, a)
    return out


def train_state_from_jax(net: nn.Module, optimizer, params: dict, batch_stats: dict,
                         iteration, opt_state=None) -> TrainState:
    """The stage-1 AvatarNet `net` loaded with a JAX TrainState's params and
    batch_stats (numpy trees), wrapped with `optimizer` at the JAX state's
    iteration; with `opt_state` (the optax state as a numpy tree) the
    optimizer takes its counts and moments, else it stays as it is."""
    net.load_state_dict(state_dict_from_jax(params, batch_stats))
    if opt_state is not None:
        optimizer.load_state_dict(optimizer_state_from_jax(opt_state))
    return TrainState(net, optimizer, int(iteration))


def jax_trees_from_port(net_sd: Dict[str, torch.Tensor], optimizer_sd: Optional[dict],
                        template: dict) -> dict:
    """The port's network state_dict and GroupOptimizer.state_dict() ->
    `template` ({"params", "batch_stats", "opt_state"}: a JAX TrainState's
    trees as numpy, the optax state from build_optimizer(...).init) with
    every leaf filled from the port, shapes and dtypes as the template's.
    Without `optimizer_sd` the template's optax state is kept."""

    def fill(value, leaf):
        value = np.asarray(value)
        if value.shape != leaf.shape:
            raise ValueError(f"shape {value.shape} != the template's {leaf.shape}")
        return value.astype(leaf.dtype)

    def opt_fill(path, leaf):
        group, kind, ppath = _opt_leaf(path)
        if kind == "count":
            g = optimizer_sd[group]
            return fill(int(g["step_count"] if "step_count" in g else g["count"]), leaf)
        return fill(to_jax(ppath, optimizer_sd[group][kind][port_key(ppath)]), leaf)

    net_fill = lambda path, leaf: fill(to_jax(path, net_sd[port_key(path)]), leaf)
    return {"params": _map(net_fill, template["params"]),
            "batch_stats": _map(net_fill, template["batch_stats"]),
            "opt_state": (template["opt_state"] if optimizer_sd is None
                          else _map(opt_fill, template["opt_state"]))}
