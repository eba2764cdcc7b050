"""Carry trained weights from the JAX package's flax trees into the port.

`state_dict_from_jax(params, batch_stats)` takes the trees as nested dicts of
numpy arrays (e.g. `jax.tree.map(np.asarray, state.params)`) and returns the
`state_dict` of the port's stage-1 `AvatarNet`:

  - Dense kernel (in, out)     -> Linear weight (out, in); bias as is
  - Conv kernel HWIO           -> Conv2d weight OIHW (both are correlations)
  - BatchNorm scale / bias     -> weight / bias; batch_stats mean / var ->
                                  running_mean / running_var
  - geo_feature NHWC (1,F,F,C) -> NCHW (1,C,F,F), the port's layout
  - pose_embedding, transl_embedding as they are.

`train_state_from_jax` carries a JAX TrainState (params, batch_stats,
iteration) into the port's TrainState, so both packages can train from the
same state. Optimizer moments are not carried: a fresh run starts them at
zero on both sides.

Only numpy and torch here: the caller holds the JAX side.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from gaussianavatar_torch.engine.train_step import TrainState


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _index(name: str) -> int:
    return int(re.fullmatch(r"[A-Za-z]+_(\d+)", name).group(1))


def geom_conv_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """GeomConvLayers: {Conv_i: {kernel HWIO}} -> {convs.i.weight OIHW}."""
    return {f"convs.{_index(name)}.weight": _t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
            for name, conv in params.items()}


def shape_decoder_state_dict(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """ShapeDecoder: flax Dense_i / BatchNorm_i -> dense.i / bn.i."""
    sd = {}
    for name, layer in params.items():
        i = _index(name)
        if name.startswith("Dense_"):
            sd[f"dense.{i}.weight"] = _t(np.asarray(layer["kernel"]).T)
            sd[f"dense.{i}.bias"] = _t(layer["bias"])
        else:
            sd[f"bn.{i}.weight"] = _t(layer["scale"])
            sd[f"bn.{i}.bias"] = _t(layer["bias"])
            sd[f"bn.{i}.running_mean"] = _t(batch_stats[name]["mean"])
            sd[f"bn.{i}.running_var"] = _t(batch_stats[name]["var"])
    return sd


def pop_state_dict(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """POPDecoder (stage 1: 'conv' smoother or none)."""
    extra = set(params) - {"GeomConvLayers_0", "ShapeDecoder_0"}
    if extra:
        raise NotImplementedError(f"POP submodules not ported yet: {sorted(extra)}")
    sd = {f"geom.{k}": v for k, v in geom_conv_state_dict(params.get("GeomConvLayers_0", {})).items()}
    dec = shape_decoder_state_dict(params["ShapeDecoder_0"], batch_stats["ShapeDecoder_0"])
    sd.update({f"decoder.{k}": v for k, v in dec.items()})
    return sd


def state_dict_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """The stage-1 AvatarNet's flax params + batch_stats -> its state_dict."""
    sd = {
        "geo_feature": _t(np.asarray(params["geo_feature"]).transpose(0, 3, 1, 2)),
        "pose_embedding": _t(params["pose_embedding"]),
        "transl_embedding": _t(params["transl_embedding"]),
    }
    sd.update({f"pop.{k}": v for k, v in pop_state_dict(params["pop"], batch_stats["pop"]).items()})
    return sd


def train_state_from_jax(net: nn.Module, optimizer, params: dict, batch_stats: dict,
                         iteration) -> TrainState:
    """The stage-1 AvatarNet `net` loaded with a JAX TrainState's params and
    batch_stats (numpy trees), wrapped with a fresh `optimizer` at the JAX
    state's iteration."""
    net.load_state_dict(state_dict_from_jax(params, batch_stats))
    return TrainState(net, optimizer, int(iteration))
