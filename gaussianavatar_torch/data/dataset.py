"""Monocular avatar data (counterpart of gaussianavatar_tpu/data/dataset.py):

    data_path/{train,test}/
        images/*.png|jpg      masks/*.png
        cam_parms.npz         (static camera)    cam_parms/<name>.npz (per frame)
        smpl_parms.pth (or .npz)      smpl_parms_pred.pth (stage 2)
        inp_map/inp_posemap_{S}_{idx:08d}.npz   (stage 2: posmap{S}, (S, S, 3))

Stage 2 reads the poses from `smpl_parms_pred.pth` (export_stage_1 writes
it) and each frame's input posmap (gen_pose_map_frames writes them), as
(3, S, S) float32, the port's NCHW; with `--fixed_inp` no per-frame posmap
is read (the caller supplies the one fixed posmap).

  - `FrameTable`: the part of the JAX package's `_MonoBase` that restoring a
    trained model needs: the frame count and the per-frame pose table.
  - `MonoDatasetTrain`: training frames, each image composited onto white
    where its mask is below 128, decoded once (PIL, imported where a frame
    is decoded) and cached as uint8; `frame_u8` feeds the train loop's
    device-resident GT bank, `inp_posmap` its stage-2 posmap bank.
  - `MonoDatasetTest`: the held-out split for eval: per item the image as
    float32 in [0, 1] (the same decode), the frame's pose and translation
    (and its input posmap in stage 2).
  - `MonoDatasetNovelPose`: poses from an external folder, a fixed camera.
  - `MonoDatasetNovelView`: the camera orbiting one pose of the test split
    (`_rotate_extrinsics`).
  - `collate` and `BatchLoader` (shuffled, drop-last batches).

Items are dicts of numpy arrays, keyed like the JAX package's, with tan-fov
precomputed. The JAX package's native C++ decode path is not ported.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Dict, Iterator, List, Optional

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


def load_inp_posmap(folder: str, size: int, pose_idx: int) -> np.ndarray:
    """`folder/inp_map/inp_posemap_{size}_{pose_idx:08d}.npz` -> (3, S, S)
    float32 (the file holds (S, S, 3))."""
    path = join(folder, "inp_map", f"inp_posemap_{size}_{pose_idx:08d}.npz")
    with np.load(path) as f:
        pm = f["posmap" + str(size)]
    return np.ascontiguousarray(np.asarray(pm, np.float32).transpose(2, 0, 1))


def _read_static_cam(folder, name="cam_parms.npz"):
    with np.load(join(folder, name)) as cam:
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


class _MonoSplit(FrameTable):
    """The frames of `source_path/<split>`: names, cameras, the decode."""

    split = "train"

    def __init__(self, model_parms):
        super().__init__(model_parms, self.split)
        self.data_folder = join(model_parms.source_path, self.split)
        names = sorted(os.listdir(join(self.data_folder, "images")))
        self.name_list = [(i, n.split(".")[0]) for i, n in enumerate(names)]
        self.image_fix = names[0].split(".")[-1]
        self.no_mask = bool(model_parms.no_mask)
        if not self.no_mask:
            self.mask_fix = os.listdir(join(self.data_folder, "masks"))[0].split(".")[-1]
        self.smpl_type = model_parms.smpl_type
        self.rest_pose_data = (np.asarray(self.smpl_data["body_pose"][: self.data_length, 66:],
                                          np.float32) if self.smpl_type == "smplx" else None)
        self.cam_static = bool(model_parms.cam_static)
        if self.cam_static:
            self.R, self.T, self.intrinsic = _read_static_cam(self.data_folder)
        self.inp_posmap_size = model_parms.inp_posmap_size
        # stage 2 without --fixed_inp: every frame has its input posmap
        self.per_frame_inp = model_parms.train_stage == 2 and not model_parms.fixed_inp
        self._frames: Dict[str, np.ndarray] = {}   # name -> (3, H, W) uint8
        self._hw: Optional[tuple] = None

    def _load_cam(self, name):
        if self.cam_static:
            return self.R, self.T, self.intrinsic
        return _read_static_cam(join(self.data_folder, "cam_parms"), name + ".npz")

    def _decode(self, name) -> np.ndarray:
        """The frame composited onto white where the mask is < 128 ->
        (3, H, W) uint8. 8-bit sources make the uint8 form lossless."""
        from PIL import Image

        img = np.asarray(Image.open(join(self.data_folder, "images", f"{name}.{self.image_fix}")),
                         np.float32)
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        img = img[..., :3]
        if not self.no_mask:
            mask = np.asarray(Image.open(join(self.data_folder, "masks",
                                              f"{name}.{self.mask_fix}")))
            if mask.ndim == 3:
                mask = mask[..., 0]
            m = (mask >= 128).astype(np.float32)[..., None]
            img = img * m + (1 - m) * 255.0
        img = np.clip(img / 255.0, 0.0, 1.0).astype(np.float32)
        return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8).transpose(2, 0, 1)

    def inp_posmap(self, pose_idx: int) -> np.ndarray:
        """Frame `pose_idx`'s input posmap, (3, S, S) float32."""
        return load_inp_posmap(self.data_folder, self.inp_posmap_size, pose_idx)

    def frame_u8(self, index: int) -> np.ndarray:
        """Frame `index` as (3, H, W) uint8, decoded on first use."""
        name = self.name_list[index][1]
        if name not in self._frames:
            self._frames[name] = self._decode(name)
            self._hw = self._frames[name].shape[1:]
        return self._frames[name]

    def image_hw(self):
        """(H, W) of the frames, decoding at most one."""
        if self._hw is None:
            self.frame_u8(0)
        return self._hw

    def drop_image_cache(self):
        """Free the decoded frames (the train loop holds them on the device
        from then on)."""
        self._frames.clear()


class MonoDatasetTrain(_MonoSplit):
    """Training frames: per item the frame index, the camera and the smplx
    rest pose where the body is smplx. The images and stage 2's input
    posmaps are read through `frame_u8` and `inp_posmap` (the train loop's
    banks), not per item."""

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        pose_idx, name = self.name_list[index]
        R, T, intrinsic = self._load_cam(name)
        item = {"pose_idx": np.int32(pose_idx)}
        item.update(_camera_item(R, T, intrinsic, *self.image_hw()))
        if self.smpl_type == "smplx":
            item["rest_pose"] = self.rest_pose_data[pose_idx]
        return item


class MonoDatasetTest(_MonoSplit):
    """Held-out frames of `source_path/test` for eval: per item
    `original_image` (3, H, W) float32 in [0, 1], composited onto white by
    the mask, and the frame's `pose_data` and `transl_data` (the render
    poses the body from them, not from the trained embeddings)."""

    split = "test"

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        pose_idx, name = self.name_list[index]
        R, T, intrinsic = self._load_cam(name)
        item = {
            "original_image": self.frame_u8(index).astype(np.float32) / 255.0,
            "pose_idx": np.int32(pose_idx),
            "pose_data": self.pose_data[pose_idx],
            "transl_data": self.transl_data[pose_idx],
        }
        item.update(_camera_item(R, T, intrinsic, *self.image_hw()))
        if self.smpl_type == "smplx":
            item["rest_pose"] = self.rest_pose_data[pose_idx]
        if self.per_frame_inp:
            item["inp_pos_map"] = self.inp_posmap(pose_idx)
        return item


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class BatchLoader:
    """Shuffled (a fixed seed), drop-last batches of a dataset. Items are
    assembled on the calling thread: once the GT images live on the device
    an item is a camera and an index."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(0)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self.rng.permutation(len(self.dataset))
        for b in range(len(self)):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in idxs])


class MonoDatasetNovelPose:
    """Poses from an external folder (assets/test_pose by default), a static
    camera, height x width frames; in stage 2 (without --fixed_inp) each
    pose's input posmap from the folder's inp_map/."""

    def __init__(self, model_parms, height: int = 1024, width: int = 1024):
        self.data_folder = model_parms.test_folder
        self.smpl_type = model_parms.smpl_type
        self.inp_posmap_size = model_parms.inp_posmap_size
        self.per_frame_inp = model_parms.train_stage == 2 and not model_parms.fixed_inp
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
        if self.per_frame_inp:
            item["inp_pos_map"] = load_inp_posmap(self.data_folder, self.inp_posmap_size, index)
        return item


def _rodrigues(rotvec: np.ndarray) -> np.ndarray:
    """Axis-angle -> 3x3 rotation matrix, in float64."""
    theta = float(np.linalg.norm(rotvec))
    if theta == 0.0:
        return np.eye(3)
    k = np.asarray(rotvec, np.float64) / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _rotate_extrinsics(extrinsic, angle, trans=None, rotate_axis="y"):
    """The orbit camera's extrinsic: the camera of `extrinsic` turned by
    `angle` about `rotate_axis` through `trans` (HumanNeRF's convention, as
    the JAX package's `_rotate_extrinsics`)."""
    E = np.asarray(extrinsic, np.float64)
    inv_E = np.linalg.inv(E)
    camrot = inv_E[:3, :3]
    campos = inv_E[:3, 3]
    if trans is not None:
        campos = campos - trans
    if camrot.T[1, 1] < 0:
        angle = -angle
    vec = np.zeros(3)
    vec[{"x": 0, "y": 1, "z": 2}[rotate_axis]] = angle
    gm = _rodrigues(vec)
    rot_campos = gm @ campos
    rot_camrot = gm @ camrot
    if trans is not None:
        rot_campos = rot_campos + trans
    new_E = np.eye(4)
    new_E[:3, :3] = rot_camrot.T
    new_E[:3, 3] = -rot_camrot.T @ rot_campos
    return new_E


class MonoDatasetNovelView(_MonoSplit):
    """The camera of `source_path/test` orbiting one fixed pose of that
    split about the vertical axis ("wild" captures: the JAX package's
    default), `data_length` frames per turn, at the split's image size."""

    split = "test"

    def __init__(self, model_parms):
        super().__init__(model_parms)
        with np.load(join(self.data_folder, "cam_parms.npz")) as cam:
            self.extr_npy = np.asarray(cam["extrinsic"], np.float64)
            self.intrinsic = np.asarray(cam["intrinsic"], np.float32).reshape(3, 3)
        self.fix_pose_idx = 0
        self.Th = np.zeros(3)

    def set_fixed_pose(self, pose_idx: int, frame_num: int, pelvis_pos=None):
        """Orbit pose `pose_idx` in `frame_num` frames about pelvis +
        the frame's translation (`pelvis_pos` from the body model)."""
        self.fix_pose_idx = pose_idx
        self.data_length = frame_num
        pp = np.zeros(3) if pelvis_pos is None else np.asarray(pelvis_pos)
        self.Th = pp + self.transl_data[pose_idx]

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        pose_idx = self.fix_pose_idx
        angle = 2 * np.pi * (index / self.data_length)
        E = _rotate_extrinsics(self.extr_npy, angle, self.Th, "y")
        R = np.asarray(E[:3, :3], np.float32).reshape(3, 3).transpose(1, 0)
        T = np.asarray(E[:3, 3], np.float32)
        item = {
            "pose_idx": np.int32(pose_idx),
            "pose_data": self.pose_data[pose_idx],
            "transl_data": self.transl_data[pose_idx],
        }
        item.update(_camera_item(R, T, self.intrinsic, *self.image_hw()))
        if self.smpl_type == "smplx":
            item["rest_pose"] = self.rest_pose_data[pose_idx]
        if self.per_frame_inp:
            item["inp_pos_map"] = self.inp_posmap(pose_idx)
        return item
