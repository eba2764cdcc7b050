"""From Config to runtime objects (counterpart of
gaussianavatar_tpu/engine/setup.py): body model, avatar assets and the
network, on the caller's device. Two asset sources:

  1. the reference-preprocessed files if all present (query posmap npz,
     lbs map npy, canonical joint mats pth, uv face-id mask), or
  2. computed in-process from the body model + template UV mesh
     (`build_avatar_assets`).

`dataset_type == "synthetic"` swaps the licensed SMPL files for the
procedural body. With `train=True` the bundle's frame table is the training
dataset (`MonoDatasetTrain`, whose first frame gives H and W); the pose and
transl embeddings start from the split's smpl_parms either way (stage 2:
smpl_parms_pred.pth). The network is the stage's: stage 2 adds the pose
encoder.
"""

from __future__ import annotations

import os
from os.path import join
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussianavatar_torch.config import Config, smpl_canonical_pose, smplx_canonical_pose
from gaussianavatar_torch.data.dataset import FrameTable, MonoDatasetTrain
from gaussianavatar_torch.models.avatar import AvatarAssets, AvatarNet, build_avatar_assets, pad_assets
from gaussianavatar_torch.models.body import BodyModel, load_body_model
from gaussianavatar_torch.ops.uv_raster import uv_coord_map
from gaussianavatar_torch.utils.obj_io import load_obj
from gaussianavatar_torch.utils.synthetic import synthetic_body


class AvatarBundle(NamedTuple):
    body_model: BodyModel
    assets: AvatarAssets
    net: AvatarNet
    frames: FrameTable


def _load_reference_assets(mp, betas: np.ndarray, J: int, device) -> Optional[AvatarAssets]:
    """The reference's preprocessed artifacts, if they all exist."""
    R, st = mp.query_posmap_size, mp.smpl_type
    query_map_path = join(mp.source_path, "train", f"query_posemap_{R}_cano_{st}.npz")
    lbs_path = join(mp.project_path, "assets", f"lbs_map_{st}_{R}.npy")
    mat_path = join(mp.source_path, "train", f"{st}_cano_joint_mat.pth")
    mask_path = join(mp.project_path, "assets", "uv_masks", f"uv_mask{R}_with_faceid_{st}.npy")
    if not all(os.path.exists(p) for p in (query_map_path, lbs_path, mat_path, mask_path)):
        return None
    with np.load(query_map_path) as f:
        query_map = f["posmap" + str(R)].reshape(-1, 3)
    lbs_map = np.load(lbs_path).reshape(R * R, J)
    faceid = np.load(mask_path).reshape(-1)
    cano_mats = np.asarray(torch.load(mat_path, map_location="cpu", weights_only=True))
    inv_mats = np.linalg.inv(cano_mats.reshape(J, 4, 4)).astype(np.float32)

    valid_idx = np.flatnonzero(faceid != -1).astype(np.int64)
    return pad_assets(query_map[valid_idx].astype(np.float32),
                      lbs_map[valid_idx].astype(np.float32), valid_idx,
                      uv_coord_map(R)[valid_idx], inv_mats, betas, R, 256, device)


def setup_avatar(cfg: Config, device: str = "cuda", train: bool = False) -> AvatarBundle:
    mp, npar = cfg.model, cfg.net
    if npar.pos_encoding:
        raise NotImplementedError("--pos_encoding is not ported yet to gaussianavatar_torch "
                                  "(ROADMAP Queue 1, optional terms)")
    frames = MonoDatasetTrain(mp) if train else FrameTable(mp)
    betas = np.asarray(frames.smpl_data["beta"], np.float32).reshape(-1)

    if mp.dataset_type == "synthetic":
        body_model, uv = synthetic_body()
        betas = np.zeros(body_model.shapedirs.shape[-1], np.float32)
        J = body_model.parents.shape[0]
        cano_pose = np.zeros(J * 3, np.float32)
        cano_transl = None
        uv_parts = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt)
    else:
        path = mp.smplx_model_path if mp.smpl_type == "smplx" else mp.smpl_model_path
        body_model = load_body_model(path, mp.smpl_type, mp.smpl_gender,
                                     num_betas=len(betas) if len(betas) else 10)
        J = body_model.parents.shape[0]
        cano_pose = smplx_canonical_pose() if mp.smpl_type == "smplx" else smpl_canonical_pose()
        cano_transl = np.array([0.0, 0.3, 0.0], np.float32)  # reference canonical +0.3y
        obj_path = join(mp.project_path, "assets", f"template_mesh_{mp.smpl_type}_uv.obj")
        uv_parts = None
        if os.path.exists(obj_path):
            mesh = load_obj(obj_path)
            uv_parts = (body_model.v_template.numpy(), mesh.uvs, mesh.faces_v, mesh.faces_vt)

    assets = _load_reference_assets(mp, betas, J, device)
    if assets is None:
        if uv_parts is None:
            raise FileNotFoundError(
                "no preprocessed assets found and no template UV mesh available; provide "
                f"assets/template_mesh_{mp.smpl_type}_uv.obj")
        assets = build_avatar_assets(body_model, *uv_parts, cano_pose=cano_pose, betas=betas,
                                     query_res=mp.query_posmap_size, cano_transl=cano_transl,
                                     device=device)

    net = AvatarNet(
        num_frames=len(frames),
        pose_dim=frames.pose_data.shape[1],
        c_geom=npar.c_geom,
        c_pose=npar.c_pose,
        inp_posmap_size=mp.inp_posmap_size,
        hsize=npar.hsize,
        nf=npar.nf,
        geom_layer_type=npar.geom_layer_type or None,
        up_mode=npar.up_mode,
        use_dropout=bool(npar.use_dropout),
        train_stage=mp.train_stage,
        compute_dtype="bfloat16" if npar.bf16_decoder else "float32",
        pose_init=frames.pose_data,
        transl_init=frames.transl_data,
        device=device,
    )
    return AvatarBundle(body_model=body_model.to(device), assets=assets, net=net, frames=frames)
