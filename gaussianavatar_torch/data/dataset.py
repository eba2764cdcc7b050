"""Monocular avatar data (counterpart of gaussianavatar_tpu/data/dataset.py),
as far as rendering needs it:

    data_path/{train,test}/
        images/*.png|jpg      cam_parms.npz   smpl_parms.pth (or .npz)

  - `FrameTable`: the part of the JAX package's `_MonoBase` that restoring a
    trained model needs: the frame count and the per-frame pose table.
  - `MonoDatasetNovelPose`: poses from an external folder, a fixed camera.

Items are dicts of numpy arrays, keyed like the JAX package's, with tan-fov
precomputed. Frame decoding (PIL) comes with the eval and training slices.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Dict

import numpy as np
import torch

from gaussianavatar_torch.ops.camera import focal2fov, projection_from_intrinsics, world_to_view

ZNEAR, ZFAR = 0.01, 100.0


def load_smpl_parms(path: str) -> Dict[str, np.ndarray]:
    """Read smpl_parms (.npz, or a torch .pth through weights_only loading)."""
    if path.endswith(".npz") or (not os.path.exists(path) and os.path.exists(path + ".npz")):
        path = path if path.endswith(".npz") else path + ".npz"
        with np.load(path) as f:
            return {k: np.asarray(v) for k, v in f.items()}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return {k: np.asarray(v) for k, v in obj.items()}


def _camera_item(R, T, intrinsic, height, width):
    """Per-item camera arrays in the transposed convention."""
    fovx = focal2fov(intrinsic[0, 0], width)
    fovy = focal2fov(intrinsic[1, 1], height)
    w2v = world_to_view(R, T).T
    proj = projection_from_intrinsics(ZNEAR, ZFAR, intrinsic, height, width).T
    full = w2v @ proj
    cam_center = np.linalg.inv(w2v)[3, :3]
    return {
        "FovX": np.float32(fovx),
        "FovY": np.float32(fovy),
        "tan_fovx": np.float32(np.tan(fovx * 0.5)),
        "tan_fovy": np.float32(np.tan(fovy * 0.5)),
        "world_view_transform": w2v.astype(np.float32),
        "projection_matrix": proj.astype(np.float32),
        "full_proj_transform": full.astype(np.float32),
        "camera_center": cam_center.astype(np.float32),
        "height": np.int32(height),
        "width": np.int32(width),
    }


def _read_static_cam(folder):
    with np.load(join(folder, "cam_parms.npz")) as cam:
        extr, intr = cam["extrinsic"], cam["intrinsic"]
    R = np.asarray(extr[:3, :3], np.float32).reshape(3, 3).transpose(1, 0)
    T = np.asarray(extr[:3, 3], np.float32)
    return R, T, np.asarray(intr, np.float32).reshape(3, 3)


class FrameTable:
    """Frame count and per-frame SMPL parameters of a training split."""

    def __init__(self, model_parms, split: str = "train"):
        folder = join(model_parms.source_path, split)
        parms_name = "smpl_parms.pth" if model_parms.train_stage == 1 else "smpl_parms_pred.pth"
        self.smpl_data = load_smpl_parms(join(folder, parms_name))
        self.data_length = len(os.listdir(join(folder, "images")))
        body_pose = self.smpl_data["body_pose"][: self.data_length]
        if model_parms.smpl_type == "smplx":
            body_pose = body_pose[:, :66]
        self.pose_data = np.asarray(body_pose, np.float32)
        self.transl_data = np.asarray(self.smpl_data["trans"][: self.data_length], np.float32)

    def __len__(self):
        return self.data_length


class MonoDatasetNovelPose:
    """Poses from an external folder (assets/test_pose by default), a static
    camera, height x width frames."""

    def __init__(self, model_parms, height: int = 1024, width: int = 1024):
        self.data_folder = model_parms.test_folder
        self.smpl_type = model_parms.smpl_type
        if model_parms.train_stage != 1:
            raise NotImplementedError("the port renders stage-1 avatars; stage 2 comes later")
        self.height, self.width = height, width

        self.smpl_data = load_smpl_parms(join(self.data_folder, "smpl_parms.pth"))
        self.data_length = int(self.smpl_data["body_pose"].shape[0])
        body_pose = np.asarray(self.smpl_data["body_pose"], np.float32)
        if self.smpl_type == "smplx":
            self.pose_data, self.rest_pose_data = body_pose[:, :66], body_pose[:, 66:]
        else:
            self.pose_data, self.rest_pose_data = body_pose, None
        self.transl_data = np.asarray(self.smpl_data["trans"], np.float32)
        self.R, self.T, self.intrinsic = _read_static_cam(self.data_folder)

    def __len__(self):
        return self.data_length

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        item = {
            "pose_idx": np.int32(index),
            "pose_data": self.pose_data[index],
            "transl_data": self.transl_data[index],
        }
        item.update(_camera_item(self.R, self.T, self.intrinsic, self.height, self.width))
        if self.smpl_type == "smplx":
            item["rest_pose"] = self.rest_pose_data[index]
        return item
