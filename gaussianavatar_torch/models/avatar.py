"""The avatar model (counterpart of gaussianavatar_tpu/models/avatar.py):
canonical-UV Gaussians + POP decoder (+ the stage-2 pose encoder) + LBS
re-posing.

  - `AvatarAssets` bundles the preprocessed body data: canonical query
    points of the valid UV pixels, their skinning weights, inverse canonical
    joint affines, valid-pixel indices, uv coordinates, betas.
    `build_avatar_assets` computes them from a body model and a UV atlas.
  - `AvatarNet` owns the learnables: the geometry feature tensor, the
    per-frame pose/transl embeddings, the POP decoder and, in stage 2, the
    UNet pose encoder that turns a frame's input posmap into a feature map
    added to the geometry features.
  - `pose_gaussians`, `scale_warmup` and `gaussian_attributes` turn decoder
    outputs into posed world-space gaussians: opacity 1 (0 on padding),
    identity rotation, isotropic scale.

Layout choice: `geo_feature` is NCHW (1, C, F, F), PyTorch's convolution
layout; the JAX package stores it NHWC (1, F, F, C) and bridge.py transposes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from gaussianavatar_torch.models import body as body_mod
from gaussianavatar_torch.models.body import BodyModel
from gaussianavatar_torch.models.init import init_like_flax
from gaussianavatar_torch.models.layers import UnetNoCond5DS
from gaussianavatar_torch.models.pop import POPDecoder
from gaussianavatar_torch.ops.uv_raster import bary_interpolate, rasterize_uv_atlas, uv_coord_map


class AvatarAssets(NamedTuple):
    query_points: torch.Tensor   # (Nv, 3) canonical positions of valid UV px
    query_lbs: torch.Tensor      # (Nv, J) skinning weights per query point
    inv_mats: torch.Tensor       # (J, 4, 4) inverse canonical joint affines
    valid_idx: torch.Tensor      # (Nv,) int64 flat indices into R*R
    uv_coords: torch.Tensor      # (Nv, 2) normalized (row, col)/(R-1)
    betas: torch.Tensor          # (n_betas,)
    query_res: int               # R
    num_valid: int               # true count before padding

    def to(self, device) -> "AvatarAssets":
        move = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x
        return AvatarAssets(*(move(x) for x in self))


def pad_assets(qp, ql, valid_idx, uvc, inv_mats, betas, query_res, pad_to, device):
    """Pad the point count to a multiple of `pad_to` (padding points follow
    joint 0 rigidly and get opacity 0 downstream) and build AvatarAssets."""
    n = len(valid_idx)
    n_pad = (-n) % pad_to
    J = ql.shape[1]
    if n_pad:
        qp = np.concatenate([qp, np.zeros((n_pad, 3), np.float32)])
        pad_lbs = np.zeros((n_pad, J), np.float32)
        pad_lbs[:, 0] = 1.0
        ql = np.concatenate([ql, pad_lbs])
        valid_idx = np.concatenate([valid_idx, np.zeros(n_pad, valid_idx.dtype)])
        uvc = np.concatenate([uvc, np.zeros((n_pad, 2), np.float32)])
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return AvatarAssets(
        query_points=t(qp), query_lbs=t(ql), inv_mats=t(inv_mats),
        valid_idx=t(valid_idx, torch.int64), uv_coords=t(uvc),
        betas=t(np.asarray(betas, np.float32)), query_res=query_res, num_valid=n,
    )


def build_avatar_assets(
    model: BodyModel,
    uv_verts: np.ndarray,
    uv_uvs: np.ndarray,
    uv_faces_v: np.ndarray,
    uv_faces_vt: np.ndarray,
    cano_pose: np.ndarray,     # (J*3,) canonical pose
    betas: np.ndarray,         # (n_betas,)
    query_res: int = 512,
    cano_transl: Optional[np.ndarray] = None,
    pad_to: int = 256,
    device: str = "cuda",
) -> AvatarAssets:
    """Canonical-pose LBS -> UV position map -> per-pixel lbs weights ->
    valid-pixel gather, on the host (the UV rasterizer is numpy)."""
    cpu = model.to("cpu")
    J = cpu.parents.shape[0]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32).reshape(1, -1))
    cano_pose = np.asarray(cano_pose, np.float32).reshape(1, -1)
    with torch.no_grad():
        out = body_mod.forward(
            cpu, betas=t(betas), global_orient=t(cano_pose[:, :3]),
            body_pose=t(cano_pose[:, 3:]),
            transl=None if cano_transl is None else t(cano_transl),
        )
    cano_verts = out.vertices[0].numpy()
    inv_mats = np.linalg.inv(out.A[0].numpy())

    raster = rasterize_uv_atlas(cano_verts, uv_uvs, uv_faces_v, uv_faces_vt, query_res)
    lbs_map = bary_interpolate(cpu.lbs_weights.numpy(), uv_faces_v, raster)

    valid_idx = np.flatnonzero(raster.face_id.reshape(-1) >= 0).astype(np.int64)
    qp = raster.position_map.reshape(-1, 3)[valid_idx]
    ql = lbs_map.reshape(-1, J)[valid_idx]
    uvc = uv_coord_map(query_res)[valid_idx]
    return pad_assets(qp, ql, valid_idx, uvc, inv_mats, betas, query_res, pad_to, device)


# the initialisations AvatarNet offers, and the one it, setup_avatar, the
# training loops and the training CLIs take by default: the JAX package's
INITS = ("torch", "flax")
DEFAULT_INIT = "flax"


class AvatarNet(nn.Module):
    """Learnable state: geometry feature map + POP decoder + per-frame
    pose/transl embeddings (+ the stage-2 pose encoder, fresh from its
    initialisation: stage 2 copies the rest from stage 1).

    `init` picks the initialisation:
      - "torch": the geometry features 0.01 * N(0, 1) from
        `generator` (None: torch's default generator), the layers torch's
        own (kaiming_uniform(a=sqrt(5)) kernels, U(+-1/sqrt(fan_in))
        biases), drawn from torch's default generator as they are built;
      - "flax" (DEFAULT_INIT): the JAX package's `init_state(...,
        rng=PRNGKey(seed))`, value for value (models/init.py: flax's
        lecun_normal kernels and 0.01 N(0, 1) geometry features from JAX's
        own random stream, biases zero), seed = `generator.initial_seed()`
        (None: torch's `initial_seed()`, its low 32 bits as JAX's
        PRNGKey takes them); drawn on the CPU, so one seed gives the same
        state on any device.
    BatchNorm starts at scale 1, bias 0. The 'unet' smoother's dropout
    draws from the device's default generator."""

    def __init__(
        self,
        num_frames: int,
        pose_dim: int,
        c_geom: int = 64,
        c_pose: int = 64,
        inp_posmap_size: int = 128,
        hsize: int = 128,
        nf: int = 32,
        geom_layer_type: Optional[str] = "conv",
        up_mode: str = "upconv",
        use_dropout: bool = False,
        pos_encoding: bool = False,
        num_emb_freqs: int = 6,
        posemb_incl_input: bool = False,
        train_stage: int = 1,
        compute_dtype: str = "float32",
        decoder_impl: str = "ref",
        pose_init: Optional[np.ndarray] = None,
        transl_init: Optional[np.ndarray] = None,
        generator: Optional[torch.Generator] = None,
        init: str = DEFAULT_INIT,
        device: str = "cuda",
    ):
        super().__init__()
        if train_stage not in (1, 2):
            raise ValueError(f"train_stage must be 1 or 2, got {train_stage}")
        if init not in INITS:
            raise ValueError(f"init must be one of {INITS}, got {init!r}")
        F = inp_posmap_size
        geo = (torch.randn((1, c_geom, F, F), generator=generator) * 0.01 if init == "torch"
               else torch.zeros((1, c_geom, F, F)))
        self.geo_feature = nn.Parameter(geo)
        pose = np.zeros((num_frames, pose_dim), np.float32) if pose_init is None else pose_init
        transl = np.zeros((num_frames, 3), np.float32) if transl_init is None else transl_init
        self.pose_embedding = nn.Parameter(torch.as_tensor(np.asarray(pose, np.float32)))
        self.transl_embedding = nn.Parameter(torch.as_tensor(np.asarray(transl, np.float32)))
        self.pop = POPDecoder(c_geom=c_geom, geom_layer_type=geom_layer_type or None, nf=nf,
                              hsize=hsize, up_mode=up_mode, use_dropout=use_dropout,
                              pos_encoding=pos_encoding, num_emb_freqs=num_emb_freqs,
                              posemb_incl_input=posemb_incl_input,
                              compute_dtype=compute_dtype, decoder_impl=decoder_impl)
        # the input posmap is xyz: 3 channels
        self.pose_encoder = (UnetNoCond5DS(3, c_pose, nf, up_mode, use_dropout=False)
                             if train_stage == 2 else None)
        if init == "flax":
            init_like_flax(self, torch.initial_seed() if generator is None
                           else generator.initial_seed())
        self.to(device)

    def lookup(self, idx: torch.Tensor):
        """Per-frame pose/transl embedding rows."""
        return self.pose_embedding[idx], self.transl_embedding[idx]

    def decode(self, assets: AvatarAssets, batch_size: int,
               inp_posmap: Optional[torch.Tensor] = None):
        """POP decoder -> per-point (offsets * 0.02, scales, colors,
        pose_featmap). With `inp_posmap` (B, 3, F, F) the pose encoder's
        feature map (B, c_pose, F, F) joins the geometry features (stage 2);
        without it pose_featmap is None."""
        geom = self.geo_feature.expand(batch_size, -1, -1, -1)
        pose_featmap = None if inp_posmap is None else self.pose_encoder(inp_posmap)
        offs, scales, shs = self.pop(geom, assets.uv_coords, assets.valid_idx, assets.query_res,
                                     pose_featmap=pose_featmap)
        return offs * 0.02, scales, shs, pose_featmap


def pose_gaussians(
    body_model: BodyModel,
    assets: AvatarAssets,
    pose: torch.Tensor,            # (B, pose_dim) axis-angle
    transl: torch.Tensor,          # (B, 3)
    point_offsets: torch.Tensor,   # (B, Nv, 3) already x0.02
    rest_pose: Optional[torch.Tensor] = None,  # (B, 99) smplx extras
) -> torch.Tensor:
    """LBS the canonical query points into world space -> (B, Nv, 3)."""
    B = pose.shape[0]
    betas = assets.betas[None].expand(B, -1)
    kwargs = {}
    if body_model.model_type == "smplx":
        kwargs = dict(jaw_pose=rest_pose[:, :3], leye_pose=rest_pose[:, 3:6],
                      reye_pose=rest_pose[:, 6:9], left_hand_pose=rest_pose[:, 9:54],
                      right_hand_pose=rest_pose[:, 54:])
    live = body_mod.forward(body_model, betas, pose[:, :3], pose[:, 3:], transl=transl, **kwargs)
    cano2live = live.A @ assets.inv_mats[None]                       # (B, J, 4, 4)
    cano_pts = assets.query_points[None] + point_offsets              # (B, Nv, 3)
    pt_mats = torch.einsum("nj,bjpq->bnpq", assets.query_lbs, cano2live)
    return torch.einsum("bnpq,bnq->bnp", pt_mats[..., :3, :3], cano_pts) + pt_mats[..., :3, 3]


def scale_warmup(scales: torch.Tensor, iteration) -> torch.Tensor:
    """Scale warm-up: scales * 1e-3 * iteration while iteration < 1000 (the
    factor is formed in the scales' dtype, as the JAX package forms it).
    `iteration` is an int, or the train step's int32 device counter: then
    the branch is a device select of the same values (a CUDA graph of the
    step takes the branch of each replay's iteration)."""
    one_e3 = torch.full((), 1e-3, dtype=scales.dtype, device=scales.device)
    if torch.is_tensor(iteration):
        return torch.where(iteration >= 1000, scales, scales * (one_e3 * iteration))
    if iteration >= 1000:
        return scales
    return scales * (one_e3 * iteration)


def gaussian_attributes(assets: AvatarAssets, scales: torch.Tensor):
    """Isotropic scales -> 3 axes, identity rotations, opacity 1 for valid
    points and 0 for padding."""
    Nv = scales.shape[1]
    scales3 = scales.expand(-1, -1, 3)
    rotations = torch.zeros((Nv, 4), dtype=scales.dtype, device=scales.device)
    rotations[:, 0] = 1.0
    opacity = (torch.arange(Nv, device=scales.device) < assets.num_valid).to(scales.dtype)
    return scales3, rotations, opacity
