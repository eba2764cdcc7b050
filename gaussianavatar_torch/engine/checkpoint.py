"""Checkpoints in the reference's directory layout
(`model_path/net/iteration_{epoch}/`). The port keeps two files there:
`net_torch.pt`, the network's bare `state_dict` (all that rendering and
evaluation read), and `train_torch.pt`, the rest of the training state:
the optimizer groups' counts and moments and the iteration, which resuming
with `--checkpoint_epochs` needs. (The JAX package keeps the whole
TrainState in one `net.ckpt`.) A JAX checkpoint converts with
scripts/convert_jax_checkpoint_torch.py, a port checkpoint back with
scripts/convert_torch_checkpoint_jax.py. `stage_load` boots stage 2 from a
stage-1 save. A multi-subject run saves S such checkpoints, one under each
subject's model path (`save_stacked_checkpoint`), and resumes from them
(`load_stacked_checkpoint`).
"""

from __future__ import annotations

import os
import re
from os.path import join
from typing import Optional, Sequence

import torch
from torch import nn

CKPT_NAME = "net_torch.pt"
TRAIN_NAME = "train_torch.pt"


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


def save_train_state(model_path: str, epoch: int, state) -> str:
    """The network beside the optimizer and the iteration of a TrainState."""
    save_checkpoint(model_path, epoch, state.net)
    path = join(ckpt_dir(model_path, epoch), TRAIN_NAME)
    torch.save({"iteration": int(state.iteration), "optimizer": state.optimizer.state_dict()},
               path)
    return path


def load_train_state(model_path: str, epoch: int, state):
    """Restore a TrainState (network, optimizer, iteration) in place from
    `iteration_{epoch}`; -> state."""
    load_checkpoint(model_path, epoch, state.net)
    path = join(ckpt_dir(model_path, epoch), TRAIN_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found: iteration_{epoch} holds no optimizer state "
                                "to resume from")
    device = next(state.net.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.iteration = int(saved["iteration"])
    return state


def save_stacked_checkpoint(model_paths: Sequence[str], epoch: int, states: Sequence) -> list:
    """S subjects' TrainStates as S ordinary single-subject saves, one per
    model path (counterpart of the JAX package's save_stacked_checkpoint):
    `python -m gaussianavatar_torch.eval -m <path>` and single-subject
    resume take each one as it is. Each subject keeps its own embedding
    rows, so nothing is trimmed."""
    return [save_train_state(mp, epoch, st) for mp, st in zip(model_paths, states)]


def load_stacked_checkpoint(model_paths: Sequence[str], epoch: int, states: Sequence) -> list:
    """Inverse of save_stacked_checkpoint: each subject's TrainState restored
    in place from its own `iteration_{epoch}`."""
    return [load_train_state(mp, epoch, st) for mp, st in zip(model_paths, states)]


def load_checkpoint(model_path: str, epoch: int, net: nn.Module) -> nn.Module:
    path = join(ckpt_dir(model_path, epoch), CKPT_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found; a JAX checkpoint converts with "
            "scripts/convert_jax_checkpoint_torch.py")
    device = next(net.parameters()).device
    net.load_state_dict(torch.load(path, map_location=device, weights_only=True))
    return net


# what stage 2 takes from stage 1: the POP decoder (parameters and BatchNorm
# statistics), the geometry features and the per-frame embeddings
STAGE1_PREFIXES = ("pop.", "geo_feature", "pose_embedding", "transl_embedding")


def stage_load(net: nn.Module, stage1_path: str) -> nn.Module:
    """Boot a stage-2 network from a stage-1 save (`stage1_path` is its
    `net/iteration_N` directory, holding `net_torch.pt`): copy every tensor
    under STAGE1_PREFIXES; the pose encoder keeps its fresh initialisation.
    Counterpart of the JAX package's `engine/loop.stage_load`."""
    path = join(stage1_path, CKPT_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found: --stage1_out_path names a stage-1 "
                                "net/iteration_N directory of the port")
    device = next(net.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    own = net.state_dict()
    with torch.no_grad():
        for key, value in saved.items():
            if key.startswith(STAGE1_PREFIXES):
                if own[key].shape != value.shape:
                    raise ValueError(f"{key}: {tuple(value.shape)} in {path}, "
                                     f"{tuple(own[key].shape)} in this network (a stage-1 "
                                     "save of a subject with another frame count?)")
                own[key].copy_(value)
    return net


def latest_epoch(model_path: str, name: str = CKPT_NAME) -> Optional[int]:
    """The highest `iteration_N` directory that holds the port's file `name`
    (TRAIN_NAME: the newest save training can resume from)."""
    d = join(model_path, "net")
    if not os.path.isdir(d):
        return None
    epochs = [
        int(m.group(1))
        for sub in os.listdir(d)
        if (m := re.match(r"iteration_(\d+)$", sub)) and os.path.exists(join(d, sub, name))
    ]
    return max(epochs) if epochs else None
