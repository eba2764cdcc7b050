"""Linear blend skinning (counterpart of gaussianavatar_tpu/ops/lbs.py).

smplx LBS with the local modification that also returns the per-joint
relative affines `A`, which re-skin the avatar's canonical Gaussians. The
kinematic chain is a Python loop of batched 4x4 products over the
topologically sorted `parents`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from gaussianavatar_torch.ops.rotations import axis_angle_to_matrix


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """(B, n_betas) x (V, 3, n_betas) -> (B, V, 3) per-vertex displacement."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3) joint locations."""
    return torch.einsum("bik,ji->bjk", vertices, J_regressor)


@functools.lru_cache(maxsize=None)
def _index_on(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """An int64 index on `device`, made once (a CUDA graph of the train step
    cannot capture the host-to-device copy that indexing with a host array
    makes); never written."""
    return torch.as_tensor(values, dtype=torch.int64, device=device)


def batch_rigid_transform(
    rot_mats: torch.Tensor, joints: torch.Tensor, parents: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose the kinematic chain.

    rot_mats (B, J, 3, 3), joints (B, J, 3), parents (J,) with parents[0] the
    root and parents[i] < i. Returns posed joints (B, J, 3) and the relative
    transforms A (B, J, 4, 4) that map rest-space points directly."""
    parents = np.asarray(parents)
    B, J = rot_mats.shape[:2]

    rel_joints = joints.clone()
    rel_joints[:, 1:] = joints[:, 1:] - joints[:, _index_on(tuple(parents[1:].tolist()),
                                                            joints.device)]

    T_local = torch.zeros((B, J, 4, 4), dtype=rot_mats.dtype, device=rot_mats.device)
    T_local[..., :3, :3] = rot_mats
    T_local[..., :3, 3] = rel_joints
    T_local[..., 3, 3] = 1.0

    chain = [T_local[:, 0]]
    for i in range(1, J):
        chain.append(chain[parents[i]] @ T_local[:, i])
    transforms = torch.stack(chain, dim=1)  # (B, J, 4, 4)

    posed_joints = transforms[..., :3, 3]

    # A = T - [0 | T @ [j; 0]]: subtract the transform applied to the rest
    # joint; joints_h has w=0, so row 3 of the last column is unchanged
    joints_h = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    shifted = torch.einsum("bjxy,bjy->bjx", transforms, joints_h)
    rel_transforms = transforms.clone()
    rel_transforms[..., :, 3] = transforms[..., :, 3] - shifted
    return posed_joints, rel_transforms


def lbs(
    betas: torch.Tensor,
    pose: torch.Tensor,
    v_template: torch.Tensor,
    shapedirs: torch.Tensor,
    posedirs: torch.Tensor,
    J_regressor: torch.Tensor,
    parents: np.ndarray,
    lbs_weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full SMPL-family LBS. `pose` is (B, J*3) axis-angle.

    Returns verts (B, V, 3), joints (B, J, 3), A (B, J, 4, 4)."""
    B = max(betas.shape[0], pose.shape[0])
    J = np.asarray(parents).shape[0]

    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    joints = vertices2joints(J_regressor, v_shaped)

    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    rot_mats = axis_angle_to_matrix(pose.reshape(B, J, 3))
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    pose_offsets = (pose_feature @ posedirs).reshape(B, -1, 3)

    v_posed = v_shaped + pose_offsets
    posed_joints, A = batch_rigid_transform(rot_mats, joints, parents)

    # skinning: per-vertex blended transform T = W @ A
    T = torch.einsum("vj,bjpq->bvpq", lbs_weights, A)
    verts = torch.einsum("bvxy,bvy->bvx", T[..., :3, :3], v_posed) + T[..., :3, 3]
    return verts, posed_joints, A
