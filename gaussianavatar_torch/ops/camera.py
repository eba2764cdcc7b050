"""Camera math (counterpart of gaussianavatar_tpu/ops/camera.py).

The matrix helpers are numpy and follow the 3DGS conventions: matrices are
stored TRANSPOSED (row-vector convention, `x_clip = x_world @ full_proj`),
and `full_proj = world_view^T @ proj^T`. `Camera.from_extrinsics` builds the
tensors on the caller's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """World->view 4x4 (NOT transposed). R is the rotation as the data loader
    stores it (already transposed), t the camera translation."""
    translate = np.zeros(3) if translate is None else np.asarray(translate)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = np.asarray(R).transpose()
    Rt[:3, 3] = np.asarray(t).reshape(3)
    Rt[3, 3] = 1.0

    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.float32(np.linalg.inv(C2W))


def projection_from_intrinsics(
    znear: float, zfar: float, K: np.ndarray, h: float, w: float
) -> np.ndarray:
    """Off-center perspective projection 4x4 (NOT transposed) from pixel
    intrinsics K = [[fx,0,cx],[0,fy,cy],[0,0,1]]."""
    near_fx = znear / K[0, 0]
    near_fy = znear / K[1, 1]
    left = -(w - K[0, 2]) * near_fx
    right = K[0, 2] * near_fx
    bottom = (K[1, 2] - h) * near_fy
    top = K[1, 2] * near_fy
    return _frustum(znear, zfar, left, right, bottom, top)


def projection_from_fov(znear: float, zfar: float, fovX: float, fovY: float) -> np.ndarray:
    """Symmetric perspective projection 4x4 (NOT transposed) from field of view."""
    top = math.tan(fovY / 2) * znear
    right = math.tan(fovX / 2) * znear
    return _frustum(znear, zfar, -right, right, -top, top)


def _frustum(znear, zfar, left, right, bottom, top) -> np.ndarray:
    P = np.zeros((4, 4))
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return np.float32(P)


class Camera(NamedTuple):
    """One pinhole camera in the transposed convention."""

    world_view_transform: torch.Tensor  # (4,4) transposed world->view
    full_proj_transform: torch.Tensor   # (4,4) transposed world->clip
    camera_center: torch.Tensor         # (3,)
    tan_fovx: torch.Tensor              # () tan(FovX/2)
    tan_fovy: torch.Tensor              # () tan(FovY/2)
    height: int
    width: int

    @staticmethod
    def from_extrinsics(
        R: np.ndarray,
        t: np.ndarray,
        K: np.ndarray,
        height: int,
        width: int,
        znear: float = 0.01,
        zfar: float = 100.0,
        translate=None,
        scale: float = 1.0,
        device: str = "cuda",
    ) -> "Camera":
        w2v = world_to_view(R, t, translate, scale)
        proj = projection_from_intrinsics(znear, zfar, K, height, width)
        wvt = w2v.T
        full = wvt @ proj.T
        cam_center = np.linalg.inv(wvt)[3, :3]
        fovx = focal2fov(K[0, 0], width)
        fovy = focal2fov(K[1, 1], height)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
        return Camera(
            world_view_transform=f32(wvt),
            full_proj_transform=f32(full),
            camera_center=f32(cam_center),
            tan_fovx=f32(math.tan(fovx * 0.5)),
            tan_fovy=f32(math.tan(fovy * 0.5)),
            height=int(height),
            width=int(width),
        )
