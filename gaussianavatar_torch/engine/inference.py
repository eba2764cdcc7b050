"""Inference bootstrap for the render CLIs (counterpart of
gaussianavatar_tpu/engine/inference.py and of the render functions of
gaussianavatar_tpu/engine/train_step.py): rebuild the avatar from a saved
config + checkpoint and return a render function.

Stage-1 models render from a canonical cache: the decoder sees no per-frame
input, so its outputs are decoded once (`precompute_canonical`) and every
frame runs only LBS -> skinning -> projection -> binning -> the blend.
Stage-2 models decode every frame: its input posmap (`inp_pos_map` in the
batch, NCHW) goes through the pose encoder and the decoder in eval mode, B
frames per call, then the same render. `frame_gaussians` hands out what
the renderer draws (the PLY export reads it), through the same
`decode_batch` and `posed_gaussians` the render calls.
"""

from __future__ import annotations

from os.path import join
from typing import NamedTuple, Optional

import numpy as np
import torch

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
from gaussianavatar_torch.utils.spans import span

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


def decode_batch(net: AvatarNet, assets: AvatarAssets, batch: dict):
    """The decode for a batch of B frames (tensors on the device), in the
    network's current mode -> (res, scales, shs), each (B, Nv, ...). With
    `inp_pos_map` (B, 3, F, F) each frame decodes from its posmap (stage
    2); without, the decoder runs once and its output is expanded."""
    B = batch["pose_idx"].reshape(-1).shape[0]
    inp = batch.get("inp_pos_map")
    with span("render::decode", assets.query_points.device):
        res, scales, shs, _ = net.decode(assets, 1 if inp is None else B, inp)
    if inp is None:
        res, scales, shs = (x.expand(B, -1, -1) for x in (res, scales, shs))
    return res, scales, shs


def posed_gaussians(net, body_model, assets, res, scales, shs, batch, iteration):
    """Decoded gaussians (B, Nv, ...) + a batch of B poses and cameras
    (tensors on the device) -> the gaussians the renderer draws: world
    means (B, Nv, 3), colours (B, Nv, 3), scales (B, Nv, 3), rotations
    (Nv, 4) wxyz and opacities (Nv,), padding included (opacity 0). Poses
    come from the batch's `pose_data` / `transl_data` if it has them, else
    from the trained embeddings."""
    idx = batch["pose_idx"].long().reshape(-1)
    if "pose_data" in batch:
        pose, transl = batch["pose_data"], batch["transl_data"]
    else:
        pose, transl = net.lookup(idx)
    with span("render::pose_gaussians", res.device):
        world = pose_gaussians(body_model, assets, pose, transl, res,
                               rest_pose=batch.get("rest_pose"))
    with span("render::attributes", res.device):
        scales3, rotations, opacity = gaussian_attributes(assets, scale_warmup(scales, iteration))
    return world, shs, scales3, rotations, opacity


def _render_posed(net, body_model, assets, res, scales, shs, batch, H, W, bg,
                  raster_cfg, iteration):
    """Decoded gaussians (B, Nv, ...) + a batch of B poses/cameras ->
    ((B, 3, H, W), overflow)."""
    world, colors, scales3, rotations, opacity = posed_gaussians(
        net, body_model, assets, res, scales, shs, batch, iteration)
    B = world.shape[0]
    return rasterize_views(
        world, colors, scales3, rotations, opacity,
        batch["world_view_transform"], batch["full_proj_transform"],
        batch["tan_fovx"].reshape(B), batch["tan_fovy"].reshape(B), H, W, bg,
        config=raster_cfg,
    )


def precompute_canonical(net: AvatarNet, assets: AvatarAssets):
    """Stage-1 decoder outputs are pose-independent: decode ONCE."""
    with torch.no_grad(), span("render::decode", assets.query_points.device):
        res, scales, shs, _ = net.decode(assets, 1)
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
        b = _to_device(batch, device)
        B = b["pose_idx"].reshape(-1).shape[0]
        res, scales, shs = (x[None].expand(B, -1, -1) for x in cache)
        out = _render_posed(net, body_model, assets, res, scales, shs, b, H, W, bg,
                            raster_cfg, iteration)
        return out if with_overflow else out[0]

    return render


def make_render_fn(net: AvatarNet, body_model: BodyModel, assets: AvatarAssets,
                   H: int, W: int, bg_color, raster_cfg: RasterizeConfig,
                   with_overflow: bool = False):
    """Full-decode renderer: render(batch, iteration=...) decodes on every
    call, in the network's current mode. With `inp_pos_map` (B, 3, F, F) in
    the batch it decodes each of the B frames from its posmap (stage 2);
    without, it decodes once and expands (stage 1)."""
    device = assets.query_points.device
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=device)

    @torch.no_grad()
    def render(batch, iteration: int = INFERENCE_ITERATION):
        b = _to_device(batch, device)
        res, scales, shs = decode_batch(net, assets, b)
        out = _render_posed(net, body_model, assets, res, scales, shs, b, H, W, bg,
                            raster_cfg, iteration)
        return out if with_overflow else out[0]

    return render


def make_renderer(inf: InferenceBundle, height: int, width: int,
                  with_overflow: bool = False):
    """render(batch, iteration=...) for a trained avatar: stage 1 through
    the canonical cache, stage 2 decoding every frame from the batch's
    `inp_pos_map`. Each call is the span `render::call`."""
    cfg, bundle = inf.cfg, inf.bundle
    rcfg = raster_config(cfg)
    bg = (1.0, 1.0, 1.0) if cfg.model.white_background else (0.0, 0.0, 0.0)
    device = bundle.assets.query_points.device
    if cfg.model.train_stage == 2:
        draw = make_render_fn(bundle.net, bundle.body_model, bundle.assets, height, width, bg,
                              rcfg, with_overflow=with_overflow)
    else:
        cache = precompute_canonical(bundle.net, bundle.assets)
        cached = make_cached_render_fn(bundle.net, bundle.body_model, bundle.assets,
                                       height, width, bg, rcfg, with_overflow=with_overflow)
        draw = lambda batch, iteration: cached(cache, batch, iteration)

    def render(batch, iteration: int = INFERENCE_ITERATION):
        with span("render::call", device):
            return draw(batch, iteration)

    return render


@torch.no_grad()
def frame_gaussians(bundle: AvatarBundle, batch: dict, iteration: int = INFERENCE_ITERATION):
    """The posed gaussians the renderer draws for a batch (arrays or
    tensors, as `batch_from_item` makes it), in the network's current mode:
    `posed_gaussians` of the stage's decode (stage 1 once; stage 2 from the
    batch's `inp_pos_map`, or with no pose feature map when the batch has
    none)."""
    b = _to_device(batch, bundle.assets.query_points.device)
    res, scales, shs = decode_batch(bundle.net, bundle.assets, b)
    return posed_gaussians(bundle.net, bundle.body_model, bundle.assets, res, scales, shs, b,
                           iteration)


def load_fixed_inp(mp) -> Optional[np.ndarray]:
    """The one input posmap (3, F, F) of a `--fixed_inp` stage-2 model
    (ModelParams `mp`): the canonical posmap at the input resolution; None
    for other models."""
    if mp.train_stage != 2 or not mp.fixed_inp:
        return None
    S = mp.inp_posmap_size
    path = join(mp.source_path, "train", f"query_posemap_{S}_cano_{mp.smpl_type}.npz")
    with np.load(path) as f:
        return np.ascontiguousarray(f["posmap" + str(S)].astype(np.float32).transpose(2, 0, 1))


def batch_from_item(item: dict, fix_inp: Optional[np.ndarray] = None) -> dict:
    """Dataset item -> single-frame batch (numpy, leading dim 1); `fix_inp`
    (3, F, F) becomes its input posmap."""
    drop = {"FovX", "FovY", "height", "width", "projection_matrix",
            "camera_center", "original_image"}
    batch = {k: np.asarray(v)[None] for k, v in item.items() if k not in drop}
    if fix_inp is not None:
        batch["inp_pos_map"] = fix_inp[None]
    return batch
