"""The train step (counterpart of make_train_step in
gaussianavatar_tpu/engine/train_step.py), stage 1 and stage 2:

    GT from the uint8 bank on the device, indexed by pose_idx
    -> embedding lookup
    -> POP decode in training mode. Stage 1: ONCE (the decoder sees no
       per-frame input; BatchNorm on the statistics of that one copy, as the
       JAX dedup takes them), then expanded to the batch. Stage 2: the B
       frames' input posmaps (from the posmap bank on the device, indexed
       by pose_idx, or the one fixed posmap) through the UNet pose encoder,
       B decodes, the decoder's BatchNorm statistics over all B x Nv points
    -> LBS + skinning -> scale warm-up at the step's iteration (stage 1)
    -> rasterize (H-fwd; H-bwd on the way back)
    -> loss, stage 1 = scale + offset + L1 * (1 - lambda_dssim)
                       + lambda_dssim * (1 - SSIM) + geo;
       stage 2 = offset + L1 * (1 - lambda_dssim) + lambda_dssim * (1 - SSIM)
                 + lambda_pose * mean(pose_featmap^2);
       with LPIPS weights, + lpips_gate * lambda_lpips * LPIPS(images, GT)
       (both mapped to [-1, 1]; logged as `vgg` whatever the gate);
       with a neighbour graph (`aiap_nn`, --use_aiap), + lambda_aiap *
       aiap_loss(query points + offsets, world points) over the valid
       points (logged as `aiap`)
    -> backward -> embedding gradients times the pose-optimization gate
    -> the optimizer groups (engine/optim.py).

Where the JAX step returns a new state, this one updates `TrainState` in
place: the network's parameters and BatchNorm statistics, the optimizer's
moments, and the iteration counter. The stages open `train::*` and
`render::*` profiler ranges (scripts/torch_train_profile.py reads them);
each costs one `record_function` per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from gaussianavatar_torch.engine.inference import _to_device
from gaussianavatar_torch.engine.optim import GroupOptimizer
from gaussianavatar_torch.models.avatar import (
    AvatarAssets, AvatarNet, gaussian_attributes, pose_gaussians, scale_warmup,
)
from gaussianavatar_torch.models.body import BodyModel
from gaussianavatar_torch.ops.knn import aiap_loss
from gaussianavatar_torch.ops.rasterize import RasterizeConfig, rasterize_views
from gaussianavatar_torch.ops.ssim import l1_loss, ssim


@dataclass
class TrainState:
    net: AvatarNet
    optimizer: GroupOptimizer
    iteration: int = 0   # optimizer steps taken


def make_train_step(
    net: AvatarNet,
    body_model: BodyModel,
    assets: AvatarAssets,
    opt_cfg,
    H: int,
    W: int,
    bg_color,
    raster_cfg: RasterizeConfig,
    gt_bank: torch.Tensor,           # (n_frames, 3, H, W) uint8 on the device
    train_stage: int = 1,
    lpips_fn: Optional[Callable] = None,   # ops/lpips.LPIPS on the device, or None
    aiap_nn: Optional[torch.Tensor] = None,   # (num_valid, k) neighbour indices, --use_aiap
    inp_bank: Optional[torch.Tensor] = None,  # (n_frames | 1, 3, F, F) f32, stage 2
):
    """-> train_step(state, batch, w_rgl, pose_opt_gate, lpips_gate) ->
    (terms, images): one optimizer step on `batch` (numpy arrays keyed as
    the dataset's items, without the image). `terms` holds the loss terms,
    `total` and `raster_overflow` as detached scalars; the gates are floats,
    0 or 1. Stage 2 needs `inp_bank`: every training frame's input posmap,
    or one row, the fixed posmap every frame takes."""
    if train_stage not in (1, 2):
        raise ValueError(f"train_stage must be 1 or 2, got {train_stage}")
    if train_stage == 2 and inp_bank is None:
        raise ValueError("stage 2 needs the input posmap bank (inp_bank)")
    device = assets.query_points.device
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=device)
    embeddings = (net.pose_embedding, net.transl_embedding)

    def train_step(state: TrainState, batch: dict, w_rgl: float, pose_opt_gate: float,
                   lpips_gate: float = 0.0):
        with record_function("train::step"):
            return _step(state, batch, w_rgl, pose_opt_gate, lpips_gate)

    def _step(state, batch, w_rgl, pose_opt_gate, lpips_gate):
        iteration = state.iteration + 1
        b = _to_device(batch, device)
        idx = b["pose_idx"].long().reshape(-1)
        B = idx.shape[0]
        gt = gt_bank[idx].float() / 255.0
        net.train()
        state.optimizer.zero_grad()

        with record_function("train::decode"):
            pose, transl = net.lookup(idx)
            if train_stage == 1:
                # the stage-1 decoder sees no per-frame input: decode once, expand
                res, scales, shs, _ = net.decode(assets, 1)
                res, scales, shs = (x.expand(B, -1, -1) for x in (res, scales, shs))
            else:
                inp = inp_bank[idx * 0 if inp_bank.shape[0] == 1 else idx]
                res, scales, shs, pose_featmap = net.decode(assets, B, inp)
        with record_function("render::pose_gaussians"):
            world = pose_gaussians(body_model, assets, pose, transl, res,
                                   rest_pose=b.get("rest_pose"))
        with record_function("render::attributes"):
            # the scale warm-up is stage 1's only
            scales3, rotations, opacity = gaussian_attributes(
                assets, scale_warmup(scales, iteration) if train_stage == 1 else scales)
        images, overflow = rasterize_views(
            world, shs, scales3, rotations, opacity,
            b["world_view_transform"], b["full_proj_transform"],
            b["tan_fovx"].reshape(B), b["tan_fovy"].reshape(B), H, W, bg, config=raster_cfg)

        with record_function("train::loss"):
            l1 = (1.0 - opt_cfg.lambda_dssim) * l1_loss(images, gt)
            ssim_loss = opt_cfg.lambda_dssim * (1.0 - ssim(images, gt))
            offset_loss = w_rgl * torch.mean(res ** 2)
            if train_stage == 1:
                geo_loss = torch.mean(net.geo_feature ** 2)
                scale_loss = opt_cfg.lambda_scale * torch.mean(scales3)
                loss = scale_loss + offset_loss + l1 + ssim_loss + geo_loss
                terms = dict(l1=l1, ssim=ssim_loss, scale=scale_loss, offset=offset_loss,
                             geo=geo_loss)
            else:
                pose_loss = torch.mean(pose_featmap ** 2) * opt_cfg.lambda_pose
                loss = offset_loss + l1 + ssim_loss + pose_loss
                terms = dict(l1=l1, ssim=ssim_loss, offset=offset_loss, pose=pose_loss)
            if aiap_nn is not None:
                with record_function("train::aiap"):
                    nv = assets.num_valid
                    cano = assets.query_points[None, :nv] + res[:, :nv]
                    aiap = opt_cfg.lambda_aiap * aiap_loss(cano, world[:, :nv], aiap_nn)
                loss = loss + aiap
                terms["aiap"] = aiap
        if lpips_fn is not None:
            with record_function("train::lpips"):
                # at gate 0 the term is only logged: it leaves no gradient
                with torch.set_grad_enabled(lpips_gate != 0.0):
                    vgg = opt_cfg.lambda_lpips * lpips_fn((images - 0.5) * 2, (gt - 0.5) * 2)
                if lpips_gate != 0.0:
                    loss = loss + lpips_gate * vgg
                terms["vgg"] = vgg
        with record_function("train::backward"):
            loss.backward()

        with record_function("train::optimizer"):
            # the epoch gate of pose optimization: zero gradients touch no row
            for p in embeddings:
                if p.grad is not None:
                    p.grad.mul_(pose_opt_gate)
            state.optimizer.step()
        state.iteration = iteration
        terms.update(total=loss, raster_overflow=overflow.to(torch.float32))
        return {k: v.detach() for k, v in terms.items()}, images.detach()

    return train_step
