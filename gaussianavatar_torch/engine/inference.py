"""Inference bootstrap for the render CLIs (counterpart of
gaussianavatar_tpu/engine/inference.py and of the render functions of
gaussianavatar_tpu/engine/train_step.py): rebuild the avatar from a saved
config + checkpoint and return a render function.

Stage-1 models render from a canonical cache: the decoder sees no per-frame
input, so its outputs are decoded once (`precompute_canonical`) and every
frame runs only LBS -> skinning -> projection -> binning -> the blend.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from gaussianavatar_torch.config import Config
from gaussianavatar_torch.engine import checkpoint as ckpt
from gaussianavatar_torch.engine.setup import AvatarBundle, setup_avatar
from gaussianavatar_torch.models.avatar import (
    AvatarAssets,
    AvatarNet,
    gaussian_attributes,
    pose_gaussians,
    scale_warmup,
)
from gaussianavatar_torch.models.body import BodyModel
from gaussianavatar_torch.ops.rasterize import RasterizeConfig, raster_config, rasterize_views

# the iteration inference renders at: past the scale warm-up
INFERENCE_ITERATION = 10**6


def require_device(device: str) -> torch.device:
    """The device an entry point was asked for. CUDA that is not there is an
    error: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run on the CPU")
    return dev


class InferenceBundle(NamedTuple):
    cfg: Config
    bundle: AvatarBundle
    epoch: int


def load_trained(cfg: Config, epoch: Optional[int] = None, device: str = "cuda") -> InferenceBundle:
    require_device(device)
    bundle = setup_avatar(cfg, device=device)
    if epoch is None:
        epoch = ckpt.latest_epoch(cfg.model.model_path)
        if epoch is None:
            raise FileNotFoundError(
                f"no {ckpt.CKPT_NAME} under {cfg.model.model_path}/net/iteration_*")
    ckpt.load_checkpoint(cfg.model.model_path, epoch, bundle.net)
    bundle.net.eval()
    return InferenceBundle(cfg=cfg, bundle=bundle, epoch=epoch)


def _to_device(batch: dict, device) -> dict:
    """Batch arrays -> tensors on `device`, floating point as float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.float() if t.is_floating_point() else t
    return out


def _render_posed(net, body_model, assets, res, scales, shs, batch, H, W, bg,
                  raster_cfg, iteration):
    """Decoded canonical gaussians (Nv, ...) + a batch of poses/cameras ->
    ((B, 3, H, W), overflow)."""
    idx = batch["pose_idx"].long().reshape(-1)
    B = idx.shape[0]
    if "pose_data" in batch:
        pose, transl = batch["pose_data"], batch["transl_data"]
    else:
        pose, transl = net.lookup(idx)
    with record_function("render::pose_gaussians"):
        world = pose_gaussians(body_model, assets, pose, transl, res[None].expand(B, -1, -1),
                               rest_pose=batch.get("rest_pose"))
    with record_function("render::attributes"):
        scales_w = scale_warmup(scales[None], iteration)
        scales3, rotations, opacity = gaussian_attributes(assets, scales_w.expand(B, -1, -1))
    return rasterize_views(
        world, shs[None].expand(B, -1, -1), scales3, rotations, opacity,
        batch["world_view_transform"], batch["full_proj_transform"],
        batch["tan_fovx"].reshape(B), batch["tan_fovy"].reshape(B), H, W, bg,
        config=raster_cfg,
    )


def precompute_canonical(net: AvatarNet, assets: AvatarAssets):
    """Stage-1 decoder outputs are pose-independent: decode ONCE."""
    with torch.no_grad():
        res, scales, shs = net.decode(assets, 1)
    return res[0], scales[0], shs[0]


def make_cached_render_fn(net: AvatarNet, body_model: BodyModel, assets: AvatarAssets,
                          H: int, W: int, bg_color, raster_cfg: RasterizeConfig,
                          with_overflow: bool = False):
    """Stage-1 novel-pose renderer over a precomputed canonical cache:
    render(cache, batch, iteration=...) -> (B, 3, H, W) [, overflow]."""
    device = assets.query_points.device
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=device)

    @torch.no_grad()
    def render(cache, batch, iteration: int = INFERENCE_ITERATION):
        res, scales, shs = cache
        out = _render_posed(net, body_model, assets, res, scales, shs,
                            _to_device(batch, device), H, W, bg, raster_cfg, iteration)
        return out if with_overflow else out[0]

    return render


def make_render_fn(net: AvatarNet, body_model: BodyModel, assets: AvatarAssets,
                   H: int, W: int, bg_color, raster_cfg: RasterizeConfig,
                   with_overflow: bool = False):
    """Full-decode renderer: render(batch, iteration=...) decodes the
    canonical gaussians on every call, then renders like the cached path."""
    device = assets.query_points.device
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=device)

    @torch.no_grad()
    def render(batch, iteration: int = INFERENCE_ITERATION):
        res, scales, shs = net.decode(assets, 1)
        out = _render_posed(net, body_model, assets, res[0], scales[0], shs[0],
                            _to_device(batch, device), H, W, bg, raster_cfg, iteration)
        return out if with_overflow else out[0]

    return render


def make_renderer(inf: InferenceBundle, height: int, width: int,
                  with_overflow: bool = False):
    """render(batch, iteration=...) for a trained stage-1 avatar, through the
    canonical cache."""
    cfg, bundle = inf.cfg, inf.bundle
    rcfg = raster_config(cfg)
    bg = (1.0, 1.0, 1.0) if cfg.model.white_background else (0.0, 0.0, 0.0)
    cache = precompute_canonical(bundle.net, bundle.assets)
    cached = make_cached_render_fn(bundle.net, bundle.body_model, bundle.assets,
                                   height, width, bg, rcfg, with_overflow=with_overflow)

    def render(batch, iteration: int = INFERENCE_ITERATION):
        return cached(cache, batch, iteration)

    return render


def batch_from_item(item: dict) -> dict:
    """Dataset item -> single-frame batch (numpy, leading dim 1)."""
    drop = {"FovX", "FovY", "height", "width", "projection_matrix",
            "camera_center", "original_image"}
    return {k: np.asarray(v)[None] for k, v in item.items() if k not in drop}
