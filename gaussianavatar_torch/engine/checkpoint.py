"""Checkpoints in the reference's directory layout
(`model_path/net/iteration_{epoch}/`). The port keeps its own file there,
`net_torch.pt`: the network's `state_dict`. A JAX checkpoint (`net.ckpt`)
in the same directory converts with scripts/convert_jax_checkpoint_torch.py.
"""

from __future__ import annotations

import os
import re
from os.path import join
from typing import Optional

import torch
from torch import nn

CKPT_NAME = "net_torch.pt"


def ckpt_dir(model_path: str, epoch: int) -> str:
    return join(model_path, "net", f"iteration_{epoch}")


def save_state_dict(model_path: str, epoch: int, state_dict: dict) -> str:
    d = ckpt_dir(model_path, epoch)
    os.makedirs(d, exist_ok=True)
    path = join(d, CKPT_NAME)
    torch.save(state_dict, path)
    return path


def save_checkpoint(model_path: str, epoch: int, net: nn.Module) -> str:
    return save_state_dict(model_path, epoch, net.state_dict())


def load_checkpoint(model_path: str, epoch: int, net: nn.Module) -> nn.Module:
    path = join(ckpt_dir(model_path, epoch), CKPT_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found; a JAX checkpoint converts with "
            "scripts/convert_jax_checkpoint_torch.py")
    device = next(net.parameters()).device
    net.load_state_dict(torch.load(path, map_location=device, weights_only=True))
    return net


def latest_epoch(model_path: str) -> Optional[int]:
    """The highest `iteration_N` directory that holds a port checkpoint."""
    d = join(model_path, "net")
    if not os.path.isdir(d):
        return None
    epochs = [
        int(m.group(1))
        for name in os.listdir(d)
        if (m := re.match(r"iteration_(\d+)$", name)) and os.path.exists(join(d, name, CKPT_NAME))
    ]
    return max(epochs) if epochs else None
