"""Carry an avatar's state (stage 1 or 2) between the JAX package's
flax/optax trees and the port, both ways.

Leaves are named by their path in the flax trees: ("pop", "ShapeDecoder_0",
"Dense_3", "kernel") in `params`, ("pop", "ShapeDecoder_0", "BatchNorm_3",
"mean") in `batch_stats`. `port_key` names the port's tensor for such a path
and `to_port` / `to_jax` change the layout:

  - Dense kernel (in, out)     <-> Linear weight (out, in); bias as is
  - Conv kernel HWIO           <-> Conv2d weight OIHW (both are correlations)
  - ConvTranspose4x4s2 kernel  <-> ConvTranspose2d weight (in, out, kh, kw)
    HWIO, the taps of an           with the taps flipped: w = k[::-1, ::-1]
    input-dilated correlation      transposed (2, 3, 0, 1)
  - BatchNorm scale / bias     <-> weight / bias; batch_stats mean / var <->
                                   running_mean / running_var
  - geo_feature NHWC (1,F,F,C) <-> NCHW (1,C,F,F), the port's layout
  - pose_embedding, transl_embedding as they are.

The UNets (the stage-2 `pose_encoder` and the 'unet' smoother `pop/
UnetNoCond5DS_0`) name their blocks Conv2DBlock_i / UpConv2DBlock_i, each
with Conv_0 or ConvTranspose4x4s2_0 and BatchNorm_0; the port lists them as
`down.i` / `up.i` with `conv` and `bn`. The 'bottleneck' smoother's Conv_i
and ConvTranspose4x4s2_i are `down.i` and `up.i`.

An optimizer moment has its parameter's layout, so the same functions carry
the optax state: `multi_transform` over the groups net, geo, embed and
pose_enc. Stage 1 trains net and geo with optax.adam (a ScaleByAdamState
count, mu and nu, and the schedule's count) and embed with the JAX
package's SparseAdamState (step, mu, nu), pose_enc set to zero; stage 2
trains net and pose_enc with optax.adam and sets geo and embed to zero. A
group set to zero holds no state, and the port's optimizer has no such
group. Every group's moment trees mirror the params tree, with the other
groups' leaves masked out.

  - `state_dict_from_jax(params, batch_stats)`: the port's AvatarNet
    `state_dict` (`geom_conv_state_dict`, `shape_decoder_state_dict`: of
    one POP submodule).
  - `train_state_from_jax(...)`: a JAX TrainState (params, batch_stats,
    iteration and, if given, the optax state's counts and moments) into the
    port's TrainState, so both packages train on from one state.
  - `jax_trees_from_port(net_sd, optimizer_sd, template)`: the inverse, into
    a JAX TrainState's trees built by the caller (`build_optimizer(...).init`
    for the optax state) and returned filled, as numpy.
  - `subject_slot(tree, s, n_frames)`: slot s of a subject-stacked JAX tree
    (`parallel.multi_subject.stack_subjects`, a grid step's state), the
    per-frame embedding rows (and their moments) cut back to the subject's
    own count, ready for the functions above: a JAX multi-subject state
    becomes S port subjects.

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
# flax layout -> port layout
_PERM = {"nhwc": (0, 3, 1, 2), "conv": (3, 2, 0, 1), "dense": (1, 0)}
_MOMENTS = ("mu", "nu")


def _index(name: str) -> int:
    return int(re.fullmatch(r"[A-Za-z0-9]+_(\d+)", name).group(1))


def _unet_key(block: str, layer: str, leaf: str) -> str:
    """A UNet leaf (Conv2DBlock_i / UpConv2DBlock_i, its layer, the leaf)
    -> its key under the port's UNet module."""
    part = {"Conv2DBlock": "down", "UpConv2DBlock": "up"}[block.rsplit("_", 1)[0]]
    if layer.startswith("BatchNorm_"):
        return f"{part}.{_index(block)}.bn.{_BN_LEAF[leaf]}"
    return f"{part}.{_index(block)}.conv." + {"kernel": "weight", "bias": "bias"}[leaf]


def port_key(path: Sequence[str]) -> str:
    """The port's state_dict key of a flax params / batch_stats leaf path."""
    path = tuple(path)
    if path in (("geo_feature",), ("pose_embedding",), ("transl_embedding",)):
        return path[0]
    if len(path) == 4 and path[0] == "pose_encoder":
        return "pose_encoder." + _unet_key(*path[1:])
    if len(path) == 4 and path[0] == "pop":
        sub, layer, leaf = path[1:]
        i = _index(layer)
        if sub == "GeomConvLayers_0" and layer.startswith("Conv_") and leaf == "kernel":
            return f"pop.geom.convs.{i}.weight"
        if sub == "GeomConvBottleneckLayers_0" and leaf == "kernel":
            return f"pop.geom.{'down' if layer.startswith('Conv_') else 'up'}.{i}.weight"
        if sub == "ShapeDecoder_0" and layer.startswith("Dense_"):
            return f"pop.decoder.dense.{i}." + {"kernel": "weight", "bias": "bias"}[leaf]
        if sub == "ShapeDecoder_0" and layer.startswith("BatchNorm_"):
            return f"pop.decoder.bn.{i}.{_BN_LEAF[leaf]}"
    if len(path) == 5 and path[:2] == ("pop", "UnetNoCond5DS_0"):
        return "pop.geom." + _unet_key(*path[2:])
    raise NotImplementedError(f"no port counterpart for flax leaf {'/'.join(path)}")


def _layout(path: Sequence[str], ndim: int) -> Optional[str]:
    """How a flax leaf's layout differs from the port's: "nhwc", "conv",
    "conv_transpose", "dense" or None (the same)."""
    if path[0] == "geo_feature":
        return "nhwc"
    if path[-1] != "kernel":
        return None
    if ndim == 2:
        return "dense"
    return "conv_transpose" if path[-2].startswith("ConvTranspose4x4s2_") else "conv"


def to_port(path: Sequence[str], a) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    kind = _layout(path, a.ndim)
    if kind == "conv_transpose":
        a = a[::-1, ::-1].transpose(2, 3, 0, 1)
    elif kind is not None:
        a = a.transpose(_PERM[kind])
    return torch.tensor(np.ascontiguousarray(a))


def to_jax(path: Sequence[str], t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy().astype(np.float32)
    kind = _layout(path, a.ndim)
    if kind == "conv_transpose":
        a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
    elif kind is not None:
        a = a.transpose(np.argsort(_PERM[kind]))
    return np.ascontiguousarray(a)


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


_EMBED_KEYS = ("pose_embedding", "transl_embedding")


def subject_slot(tree, s: int, n_frames: Optional[int] = None):
    """Every array leaf's slot `s` along its leading (subject) axis; with
    `n_frames` the pose / transl embedding tables and their moments keep
    their first n_frames rows (the JAX package pads every subject's tables
    to the largest subject's frame count)."""
    def take(path, a):
        a = np.asarray(np.asarray(a)[s])
        if n_frames is not None and path and path[-1] in _EMBED_KEYS and a.ndim >= 2:
            a = a[:n_frames]
        return a

    return _map(take, tree)


def state_dict_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """An AvatarNet's flax params + batch_stats -> its state_dict."""
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
    """The optax state of build_optimizer (numpy tree) -> the port's
    GroupOptimizer.state_dict() layout: one entry per group that holds
    state (a group set to zero holds none)."""
    out = {}
    for path, a in _leaves(opt_state):
        group, kind, ppath = _opt_leaf(path)
        g = out.setdefault(group, {"mu": {}, "nu": {}})
        if kind == "count":
            # the embed group's SparseAdam keeps its step on the device
            if group == "embed":
                g["step_count"] = torch.tensor(int(a), dtype=torch.int32)
            else:
                g["count"] = int(a)
        else:
            g[kind][port_key(ppath)] = to_port(ppath, a)
    return out


def train_state_from_jax(net: nn.Module, optimizer, params: dict, batch_stats: dict,
                         iteration, opt_state=None) -> TrainState:
    """The AvatarNet `net` loaded with a JAX TrainState's params and
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
