"""LPIPS with the AlexNet backbone (the port's copy of
gaussianavatar_tpu/ops/lpips.py): the reference's training term
(0.2 * LPIPS after epoch 30) and third eval metric.

  - `LPIPS`, an `nn.Module` whose weights are buffers (they take no
    gradient and join no optimizer group), loaded onto the device once:
    the `_SHIFT` / `_SCALE` input layer, AlexNet relu1..relu5 (conv 11/4/2,
    then a 3/2 max-pool before convs 2 and 3), channel unit-normalisation
    with 1e-10 inside the square root, the non-negative 1x1 heads, the
    spatial mean, the sum over the five stages and the mean over the batch.
    The convolutions are PyTorch's (the JAX package computes them with
    `lax.conv`, outside any Pallas kernel); TF32 stays off (package init).
  - the loaders: `load_lpips_weights` (the converted npz), `weights_from_pth`
    (the raw torchvision AlexNet state dict and the lpips v0.1 heads, read
    with `torch.load(weights_only=True)`), `try_load_lpips` (the project's
    `assets/lpips`, then the repository's) and `lpips_status`, whose strings
    are the JAX package's, letter for letter.

No weights ship with the repository: without them the term is skipped, as
with `--no_lpips`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# lpips input normalization constants (ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet feature config: (out_ch, kernel, stride, pad, maxpool_before)
_ALEX_CFG = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]

INACTIVE = ("inactive (no weights: drop lpips_alex.npz or "
            "alexnet*.pth + alex.pth under assets/lpips/)")


class LPIPS(nn.Module):
    """lpips(img0, img1) -> the mean LPIPS distance of two (B, 3, H, W)
    batches in [-1, 1]. Both go through AlexNet as one batch of 2B."""

    def __init__(self, weights: Dict[str, np.ndarray], device="cpu"):
        super().__init__()
        buf = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        for i in range(len(_ALEX_CFG)):
            self.register_buffer(f"conv{i}_w", buf(weights[f"conv{i}_w"]))
            self.register_buffer(f"conv{i}_b", buf(weights[f"conv{i}_b"]))
            self.register_buffer(f"lin{i}", buf(weights[f"lin{i}"]).reshape(1, -1, 1, 1))
        self.register_buffer("shift", buf(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", buf(_SCALE).reshape(1, 3, 1, 1))

    def features(self, x: torch.Tensor):
        x = (x - self.shift) / self.scale
        outs = []
        for i, (_, _, s, p, pool) in enumerate(_ALEX_CFG):
            if pool:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(F.conv2d(x, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                                stride=s, padding=p))
            outs.append(x)
        return outs

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        B = img0.shape[0]
        total = 0.0
        for i, f in enumerate(self.features(torch.cat([img0, img1]))):
            f = f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)
            d = (f[:B] - f[B:]) ** 2
            val = torch.sum(d * getattr(self, f"lin{i}"), dim=1, keepdim=True)
            total = total + val.mean(dim=(1, 2, 3))
        return total.mean()


def random_lpips_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights of the exact lpips_alex.npz layout, from a seed (the
    recipe of tests/test_lpips_e2e.py): a stand-in where no pretrained
    weights are present, for timings and checks of the wiring; its
    distances mean nothing."""
    rng = np.random.default_rng(seed)
    out, c_in = {}, 3
    for i, (c_out, k, _, _, _) in enumerate(_ALEX_CFG):
        out[f"conv{i}_w"] = rng.normal(scale=0.05, size=(c_out, c_in, k, k)).astype(np.float32)
        out[f"conv{i}_b"] = np.zeros(c_out, np.float32)
        out[f"lin{i}"] = rng.uniform(0, 0.1, size=c_out).astype(np.float32)
        c_in = c_out
    return out


def load_lpips_weights(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


# torchvision AlexNet `features` indices of the 5 conv layers
_TV_CONV_IDX = (0, 3, 6, 8, 10)


def _read_pth(path: str) -> dict:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def weights_from_pth(alexnet_pth: str, lins_pth: str) -> Dict[str, np.ndarray]:
    """The weight dict from the raw torch files: the torchvision AlexNet
    state dict (`alexnet-owt-*.pth`) and the lpips v0.1 linear heads
    (`lpips/weights/v0.1/alex.pth`), either one bare or under a
    `state_dict` key."""
    feat = _read_pth(alexnet_pth)
    lins = _read_pth(lins_pth)
    as_np = lambda t: np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t,
                                 np.float32)

    out: Dict[str, np.ndarray] = {}
    for i, li in enumerate(_TV_CONV_IDX):
        out[f"conv{i}_w"] = as_np(feat[f"features.{li}.weight"])
        out[f"conv{i}_b"] = as_np(feat[f"features.{li}.bias"])
        expect = _ALEX_CFG[i][0]
        if out[f"conv{i}_w"].shape[0] != expect:
            raise ValueError(
                f"{alexnet_pth}: features.{li}.weight has "
                f"{out[f'conv{i}_w'].shape[0]} out-channels, expected {expect}"
            )
    for i in range(5):
        for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                  f"lin{i}.weight"):
            if k in lins:
                out[f"lin{i}"] = as_np(lins[k]).reshape(-1)
                break
        else:
            raise KeyError(f"{lins_pth}: no lin{i} weight found "
                           f"(keys: {sorted(lins)[:8]}...)")
    return out


_ALEXNET_PTH_NAMES = ("alexnet.pth", "alexnet-owt-7be5be79.pth",
                      "alexnet-owt-4df8aa71.pth")
_LINS_PTH_NAMES = ("alex.pth", "lpips_alex.pth", "alex_lins.pth")


def _find(dirpath: str, names) -> Optional[str]:
    for n in names:
        p = os.path.join(dirpath, n)
        if os.path.exists(p):
            return p
    return None


def try_load_lpips(project_path: str, device="cpu") -> Optional[LPIPS]:
    """An `LPIPS` on `device`, or None when no weights are found.

    Search order per directory ({project}/assets/lpips, {repo}/assets/lpips):
      1. lpips_alex.npz, pre-converted;
      2. the raw torch files: a torchvision AlexNet state dict and the
         lpips v0.1 'alex.pth' linear heads."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for d in (os.path.join(project_path, "assets", "lpips"),
              os.path.join(repo_root, "assets", "lpips")):
        npz = os.path.join(d, "lpips_alex.npz")
        if os.path.exists(npz):
            return LPIPS(load_lpips_weights(npz), device).eval()
        alexnet = _find(d, _ALEXNET_PTH_NAMES)
        lins = _find(d, _LINS_PTH_NAMES)
        if alexnet and lins:
            return LPIPS(weights_from_pth(alexnet, lins), device).eval()
    return None


def lpips_status(project_path: str) -> str:
    """The status string results.txt and metrics.jsonl record, so a skipped
    LPIPS term is visible."""
    if try_load_lpips(project_path) is not None:
        return "active"
    return INACTIVE
