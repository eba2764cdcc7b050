"""The plain reference's training step and rendering: GaussianAvatar's
stage-1 and stage-2 losses, Adam as optax writes it, and the frames the
avatar renders, composed from reference/body.py, net.py and raster.py.

A stage-1 step: the POP decode once (no per-frame input; BatchNorm over
that one copy), the frames' poses from the embedding table, LBS, the
isotropic gaussians (opacity 1, 0 on padding; the scale warm-up
x 1e-3 iteration below iteration 1000), the render under the need table's
caps, and the loss scale + offset + (1 - l_dssim) L1 + l_dssim (1 - SSIM)
+ geo. Stage 2: one decode per frame from its input posmap through the pose
encoder, BatchNorm over every frame's rows, the loss offset + L1 + SSIM +
l_pose mean(pose features^2); the geometry features and the embeddings are
frozen. Adam: the rate read at the count before the update, moments
(1 - b) g + b m, the bias corrections of the new count, eps outside the
square root. The embeddings' SparseAdam sees only zero gradients while the
pose-optimisation gate is shut (before epoch 1800), so it moves nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import body as rbody
from . import net as rnet
from . import raster as rr

B1, B2, EPS = 0.9, 0.999, 1e-8


def ssim(a: torch.Tensor, b: torch.Tensor, window: int = 11) -> torch.Tensor:
    """Mean SSIM of (B, C, H, W) batches: an 11 x 11 Gaussian window of
    sigma 1.5 as two depthwise passes with zero padding, C1 = 0.01^2,
    C2 = 0.03^2."""
    xs = np.arange(window)
    g = np.exp(-((xs - window // 2) ** 2) / (2.0 * 1.5 ** 2))
    g = torch.as_tensor((g / g.sum()).astype(np.float32), device=a.device)
    C = a.shape[1]
    st = torch.cat([a, b, a * a, b * b, a * b], 1)
    k = window // 2
    f = F.conv2d(st, g.reshape(1, 1, -1, 1).expand(5 * C, 1, -1, 1), padding=(k, 0), groups=5 * C)
    f = F.conv2d(f, g.reshape(1, 1, 1, -1).expand(5 * C, 1, 1, -1), padding=(0, k), groups=5 * C)
    m1, m2 = f[:, :C], f[:, C:2 * C]
    s1, s2, s12 = f[:, 2 * C:3 * C] - m1 * m1, f[:, 3 * C:4 * C] - m2 * m2, f[:, 4 * C:] - m1 * m2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * m1 * m2 + c1) * (2 * s12 + c2))
            / ((m1 * m1 + m2 * m2 + c1) * (s1 + s2 + c2))).mean()


def warmup(scales: torch.Tensor, iteration: int) -> torch.Tensor:
    return scales if iteration >= 1000 else scales * (1e-3 * iteration)


def gaussians(P: dict, av, c: dict, batch: dict, iteration: int, train: bool,
              posmaps: Optional[torch.Tensor] = None, q: Optional[Callable] = None,
              decoded=None):
    """The world-space gaussians of a batch of B frames: (means (B, Np, 3),
    colours, scales3 (B, Np, 3), opacity (B, Np), offsets, pose features).
    Poses come from batch['pose'] / batch['transl'] (B, 3J), (B, 3).
    `decoded` (offsets, scales, colours) of one decode to reuse (stage 1)."""
    B = batch["pose"].shape[0]
    if decoded is None:
        res, scales, shs, pf = rnet.decode(P, av, c, train, posmaps, q)
    else:
        (res, scales, shs), pf = decoded, None
    if res.shape[0] != B:
        res, scales, shs = (x.expand(B, -1, -1) for x in (res, scales, shs))
    _, A = rbody.skin(c["_body"], batch["pose"], batch["transl"])
    world = rbody.place(av, A, res)
    scales3 = warmup(scales, iteration).expand(-1, -1, 3)
    Np = res.shape[1]
    opacity = (torch.arange(Np, device=res.device) < av.num_valid).float()[None].expand(B, Np)
    return world, shs, scales3, opacity, res, pf


def draw(world, shs, scales3, opacity, batch: dict, c: dict, H: int, W: int, M: int,
         caps: Optional[torch.Tensor] = None):
    """Render the gaussians into the batch's cameras -> (images, stats)."""
    pr = rr.project(world, scales3, batch["world_view_transform"], batch["full_proj_transform"],
                    batch["tan_fovx"], batch["tan_fovy"], H, W)
    bg = torch.ones(3, device=world.device)
    return rr.render(pr, shs, opacity, bg, H, W, c["tile_size"], M, caps)


def loss(P: dict, av, c: dict, batch: dict, gt: torch.Tensor, caps: torch.Tensor,
         iteration: int, w_rgl: float, posmaps=None, q=None, fault=None) -> torch.Tensor:
    """The stage's training loss on one batch (images vs gt (B, 3, H, W)).
    `fault` "half_batch" takes the image terms over the first half of the
    batch only (a planted fault for the correctness check's readings)."""
    o = c["opt"]
    world, shs, scales3, opacity, res, pf = gaussians(P, av, c, batch, iteration, True, posmaps, q)
    H, W = gt.shape[-2:]
    img, _ = draw(world, shs, scales3, opacity, batch, c, H, W, c["max_tiles_per_gaussian"], caps)
    if fault == "half_batch":
        h = max(1, img.shape[0] // 2)
        img, gt = img[:h], gt[:h]
    l1 = (1.0 - o["lambda_dssim"]) * (img - gt).abs().mean()
    ss = o["lambda_dssim"] * (1.0 - ssim(img, gt))
    total = w_rgl * (res ** 2).mean() + l1 + ss
    if c["train_stage"] == 1:
        total = total + o["lambda_scale"] * scales3.mean() + (P["geo_feature"] ** 2).mean()
    else:
        total = total + o["lambda_pose"] * (pf ** 2).mean()
    return total


def groups(c: dict) -> Dict[str, tuple]:
    """Optimizer group -> (which leaves, base rate) of the stage: stage 1
    net at lr_net, geo at lr_geomfeat; stage 2 net at lr_net / 10, the pose
    encoder at lr_net. The embeddings are left out (see the module doc)."""
    o = c["opt"]
    if c["train_stage"] == 1:
        return {"net": (lambda n: n.startswith("pop."), o["lr_net"]),
                "geo": (lambda n: n == "geo_feature", o["lr_geomfeat"])}
    return {"net": (lambda n: n.startswith("pop."), o["lr_net"] * 0.1),
            "pose_enc": (lambda n: n.startswith("pose_encoder."), o["lr_net"])}


def train_steps(P0: Dict[str, torch.Tensor], av, c: dict, batches: List[dict], gts, caps,
                iteration: int, w_rgl: float, posmaps=None, q=None, fault=None):
    """Steps of Adam from P0 (untouched), one per batch, each from the
    iteration after the last -> {'loss': [..], 'grad1': {leaf: first
    gradient}, 'delta': {leaf: P_n - P0}} over the trained leaves."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    grp = groups(c)
    leaves = [k for k in P if any(f(k) for f, _ in grp.values())]
    mu = {k: torch.zeros_like(P[k]) for k in leaves}
    nu = {k: torch.zeros_like(P[k]) for k in leaves}
    out = {"loss": [], "grad1": {}, "delta": {}}
    for n, b in enumerate(batches):
        for k in leaves:
            P[k].requires_grad_(True)
        L = loss(P, av, c, b, gts[n], caps[n], iteration + n + 1, w_rgl,
                 None if posmaps is None else posmaps[n], q, fault)
        grads = torch.autograd.grad(L, [P[k] for k in leaves])
        out["loss"].append(float(L.detach()))
        cnt = n + 1
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                if n == 0:
                    out["grad1"][k] = g.clone()
                lr = next(r for f, r in grp.values() if f(k))
                mu[k] = (1 - B1) * g + B1 * mu[k]
                nu[k] = (1 - B2) * g * g + B2 * nu[k]
                bc1, bc2 = 1.0 - B1 ** cnt, 1.0 - B2 ** cnt
                P[k] = (P[k] - lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS))).detach()
    out["delta"] = {k: P[k] - P0[k] for k in leaves}
    return out
