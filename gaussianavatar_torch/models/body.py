"""SMPL / SMPL-X body models (counterpart of gaussianavatar_tpu/models/body.py).

A `BodyModel` is a NamedTuple of tensors (it has no learnables); `forward`
poses it and returns the vertices, the joints and the per-joint relative
affines `A`, with the global translation folded into all three. Loaders
read the official .pkl/.npz model files on the host.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussianavatar_torch.models import keypoints
from gaussianavatar_torch.ops.lbs import lbs

# the model types the avatar pipeline runs (ModelParams.smpl_type); the JAX
# package's SMPL-H, MANO, FLAME and expression blendshapes wait for a caller
MODEL_TYPES = ("smpl", "smplx")


class BodyModel(NamedTuple):
    v_template: torch.Tensor    # (V, 3)
    shapedirs: torch.Tensor     # (V, 3, n_betas)
    posedirs: torch.Tensor      # (9*(J-1), V*3)
    J_regressor: torch.Tensor   # (J, V)
    lbs_weights: torch.Tensor   # (V, J)
    parents: np.ndarray         # (J,) static int
    faces: np.ndarray           # (F, 3) static int
    model_type: str = "smpl"                        # smpl | smplx
    extra_joint_ids: Optional[np.ndarray] = None    # (E,) official meshes only

    def to(self, device) -> "BodyModel":
        move = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x
        return BodyModel(*(move(x) for x in self))


class BodyOutput(NamedTuple):
    vertices: torch.Tensor   # (B, V, 3)
    joints: torch.Tensor     # (B, J(+E), 3)
    A: torch.Tensor          # (B, J, 4, 4) relative affines (transl folded in)


def _to_np(x) -> np.ndarray:
    """Raw pickle entries (numpy, chumpy, scipy sparse) -> ndarray."""
    if hasattr(x, "r"):  # chumpy
        return np.asarray(x.r, dtype=np.float64)
    if hasattr(x, "todense"):  # scipy sparse
        return np.asarray(x.todense(), dtype=np.float64)
    return np.asarray(x)


def _from_struct(data: dict, model_type: str, num_betas: int) -> BodyModel:
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32))
    v_template = _to_np(data["v_template"]).astype(np.float32)
    shapedirs = _to_np(data["shapedirs"]).astype(np.float32)[:, :, :num_betas]
    posedirs = _to_np(data["posedirs"]).astype(np.float32)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (V,3,P) -> (P, V*3)
    J_regressor = _to_np(data["J_regressor"]).astype(np.float32)
    parents = _to_np(data["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    J = J_regressor.shape[0]
    extra_ids = None
    if keypoints.OFFICIAL_NUM_VERTS.get(model_type) == v_template.shape[0]:
        extra_ids = keypoints.extra_joint_ids(model_type)
    return BodyModel(
        v_template=t(v_template),
        shapedirs=t(shapedirs),
        posedirs=t(posedirs[: 9 * (J - 1)]),
        J_regressor=t(J_regressor),
        lbs_weights=t(_to_np(data["weights"])),
        parents=parents.astype(np.int32),
        faces=_to_np(data["f"]).astype(np.int64),
        model_type=model_type,
        extra_joint_ids=extra_ids,
    )


def load_body_model(model_path: str, model_type: str = "smpl", gender: str = "neutral",
                    num_betas: int = 10) -> BodyModel:
    """Load an official SMPL or SMPL-X (.pkl/.npz) model file, or find
    `{TYPE}_{GENDER}.pkl|npz` in a directory (smplx layout)."""
    if model_type not in MODEL_TYPES:
        raise NotImplementedError(f"model type {model_type!r}: the port has {MODEL_TYPES}")
    path = model_path
    if os.path.isdir(path):
        neutral = {"male": "m", "female": "f"}.get(gender, "neutral")
        candidates = [
            os.path.join(path, f"{model_type.upper()}_{gender.upper()}.pkl"),
            os.path.join(path, f"{model_type.upper()}_{gender.upper()}.npz"),
            os.path.join(path, f"basicmodel_{neutral}_lbs_10_207_0_v1.0.0.pkl"),
        ]
        for c in candidates:
            if os.path.exists(c):
                path = c
                break
        else:
            raise FileNotFoundError(f"no {model_type} model for gender={gender} in {model_path}")
    if path.endswith(".npz"):
        data = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    return _from_struct(data, model_type, num_betas)


def forward(
    model: BodyModel,
    betas: torch.Tensor,                     # (B, n_betas)
    global_orient: torch.Tensor,             # (B, 3)
    body_pose: torch.Tensor,                 # (B, 69 smpl | 63 smplx) axis-angle
    transl: Optional[torch.Tensor] = None,   # (B, 3)
    jaw_pose: Optional[torch.Tensor] = None,          # (B, 3) smplx
    leye_pose: Optional[torch.Tensor] = None,
    reye_pose: Optional[torch.Tensor] = None,
    left_hand_pose: Optional[torch.Tensor] = None,    # (B, 45) smplx
    right_hand_pose: Optional[torch.Tensor] = None,
) -> BodyOutput:
    """Pose the body. Full pose per model type (flat_hand_mean semantics):
      smpl:  [global(3), body(69)]
      smplx: [global(3), body(63), jaw(3), leye(3), reye(3), lhand(45), rhand(45)]"""
    B = body_pose.shape[0]
    J = model.parents.shape[0]
    if model.model_type == "smplx":
        kw = dict(dtype=global_orient.dtype, device=global_orient.device)
        z3, z45 = torch.zeros((B, 3), **kw), torch.zeros((B, 45), **kw)
        pick = lambda x, z: x if x is not None else z
        parts = [global_orient, body_pose, pick(jaw_pose, z3), pick(leye_pose, z3),
                 pick(reye_pose, z3), pick(left_hand_pose, z45), pick(right_hand_pose, z45)]
    else:
        parts = [global_orient, body_pose]
    full_pose = torch.cat(parts, dim=1)
    if full_pose.shape[1] != J * 3:
        raise ValueError(f"full pose has {full_pose.shape[1]} entries, the model needs {J * 3}")

    verts, joints, A = lbs(betas, full_pose, model.v_template, model.shapedirs,
                           model.posedirs, model.J_regressor, model.parents,
                           model.lbs_weights)
    if model.extra_joint_ids is not None:
        joints = keypoints.select_extra_joints(verts, joints, model.extra_joint_ids)
    if transl is not None:
        t = transl[:, None, :]
        verts = verts + t
        joints = joints + t
        A = A.clone()
        A[:, :, :3, 3] = A[:, :, :3, 3] + t
    return BodyOutput(vertices=verts, joints=joints, A=A)
