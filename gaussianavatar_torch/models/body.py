"""SMPL-family body models (counterpart of gaussianavatar_tpu/models/body.py):
SMPL, SMPL-H, SMPL-X with its expression blendshapes, MANO and FLAME, over
one `lbs` core, with the avatar pipeline's settings (use_pca=False,
flat_hand_mean=True).

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

MODEL_TYPES = ("smpl", "smplh", "smplx", "mano", "flame")

# joints per model type at official scale; tiny synthetic models with
# another J work as well
NUM_JOINTS = {"smpl": 24, "smplh": 52, "smplx": 55, "mano": 16, "flame": 5}


class BodyModel(NamedTuple):
    v_template: torch.Tensor    # (V, 3)
    shapedirs: torch.Tensor     # (V, 3, n_betas)
    posedirs: torch.Tensor      # (9*(J-1), V*3)
    J_regressor: torch.Tensor   # (J, V)
    lbs_weights: torch.Tensor   # (V, J)
    parents: np.ndarray         # (J,) static int
    faces: np.ndarray           # (F, 3) static int
    model_type: str = "smpl"                        # one of MODEL_TYPES
    # expression blendshapes (smplx, flame); None for the other model types
    expr_dirs: Optional[torch.Tensor] = None        # (V, 3, n_expr)
    extra_joint_ids: Optional[torch.Tensor] = None  # (E,) int64, official meshes only

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


def _from_struct(data: dict, model_type: str, num_betas: int,
                 num_expressions: int = 10) -> BodyModel:
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32))
    v_template = _to_np(data["v_template"]).astype(np.float32)
    shapedirs_all = _to_np(data["shapedirs"]).astype(np.float32)
    shapedirs = shapedirs_all[:, :, :num_betas]
    # expression dirs (smplx, flame): a file with the full 300 + 100 space
    # holds them at columns [300:], a compact one (< 400 columns) at [10:20],
    # at most 10 of them, whatever num_betas
    expr_dirs = None
    if model_type in ("smplx", "flame") and num_expressions > 0:
        if shapedirs_all.shape[-1] >= 400:
            start, n_expr = 300, num_expressions
        else:
            start, n_expr = 10, min(num_expressions, 10)
        if shapedirs_all.shape[-1] > start:
            expr_dirs = shapedirs_all[:, :, start:start + n_expr]
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
        expr_dirs=t(expr_dirs) if expr_dirs is not None else None,
        extra_joint_ids=torch.as_tensor(extra_ids) if extra_ids is not None else None,
    )


def load_body_model(model_path: str, model_type: str = "smpl", gender: str = "neutral",
                    num_betas: int = 10, num_expressions: int = 10) -> BodyModel:
    """Load an official SMPL-family (.pkl/.npz) model file, or find
    `{TYPE}_{GENDER}.pkl|npz` in a directory (smplx layout; for mano,
    gender 'right' / 'left' picks MANO_RIGHT / MANO_LEFT)."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model type {model_type!r}: one of {MODEL_TYPES}")
    path = model_path
    if os.path.isdir(path):
        neutral = {"male": "m", "female": "f"}.get(gender, "neutral")
        candidates = [
            os.path.join(path, f"{model_type.upper()}_{gender.upper()}.pkl"),
            os.path.join(path, f"{model_type.upper()}_{gender.upper()}.npz"),
            os.path.join(path, f"basicmodel_{neutral}_lbs_10_207_0_v1.0.0.pkl"),
        ]
        if model_type == "mano":
            candidates += [os.path.join(path, "MANO_RIGHT.pkl"),
                           os.path.join(path, "MANO_LEFT.pkl")]
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
    return _from_struct(data, model_type, num_betas, num_expressions)


def forward(
    model: BodyModel,
    betas: torch.Tensor,                     # (B, n_betas)
    global_orient: torch.Tensor,             # (B, 3)
    body_pose: Optional[torch.Tensor],       # (B, 69 smpl | 63 smplh/smplx | 45 mano)
    transl: Optional[torch.Tensor] = None,   # (B, 3)
    jaw_pose: Optional[torch.Tensor] = None,          # (B, 3) smplx, flame
    leye_pose: Optional[torch.Tensor] = None,
    reye_pose: Optional[torch.Tensor] = None,
    left_hand_pose: Optional[torch.Tensor] = None,    # (B, 45) smplx, smplh
    right_hand_pose: Optional[torch.Tensor] = None,
    expression: Optional[torch.Tensor] = None,        # (B, n_expr) smplx, flame
    neck_pose: Optional[torch.Tensor] = None,         # (B, 3) flame
) -> BodyOutput:
    """Pose the body. Full pose per model type (flat_hand_mean semantics,
    hand poses as they are; a part not given is zero):
      smpl:  [global(3), body(69)]
      smplh: [global(3), body(63), lhand(45), rhand(45)]
      smplx: [global(3), body(63), jaw(3), leye(3), reye(3), lhand(45), rhand(45)]
      mano:  [global(3), hand(45)]  (the hand pose as `body_pose`, or the
             right, else the left hand pose)
      flame: [global(3), neck(3), jaw(3), leye(3), reye(3)]  (`body_pose` unused)
    `expression` adds the expression blendshapes: the shape components are
    [betas, expression] over [shapedirs, expr_dirs]."""
    B = (body_pose if body_pose is not None else global_orient).shape[0]
    J = model.parents.shape[0]
    kw = dict(dtype=global_orient.dtype, device=global_orient.device)
    z3, z45 = torch.zeros((B, 3), **kw), torch.zeros((B, 45), **kw)
    pick = lambda x, z: x if x is not None else z
    if model.model_type == "smplx":
        parts = [global_orient, body_pose, pick(jaw_pose, z3), pick(leye_pose, z3),
                 pick(reye_pose, z3), pick(left_hand_pose, z45), pick(right_hand_pose, z45)]
    elif model.model_type == "smplh":
        parts = [global_orient, body_pose, pick(left_hand_pose, z45),
                 pick(right_hand_pose, z45)]
    elif model.model_type == "mano":
        hand = body_pose if body_pose is not None else (
            right_hand_pose if right_hand_pose is not None else left_hand_pose)
        parts = [global_orient, pick(hand, z45)]
    elif model.model_type == "flame":
        parts = [global_orient, pick(neck_pose, z3), pick(jaw_pose, z3), pick(leye_pose, z3),
                 pick(reye_pose, z3)]
    else:
        parts = [global_orient, body_pose]
    full_pose = torch.cat(parts, dim=1)
    if full_pose.shape[1] != J * 3:
        raise ValueError(f"full pose has {full_pose.shape[1]} entries, the model needs {J * 3}")

    shapedirs, shape_components = model.shapedirs, betas
    if expression is not None:
        if model.expr_dirs is None:
            raise ValueError(f"{model.model_type} model has no expression blendshapes loaded")
        shapedirs = torch.cat([model.shapedirs, model.expr_dirs], dim=-1)
        shape_components = torch.cat([betas, expression], dim=-1)

    verts, joints, A = lbs(shape_components, full_pose, model.v_template, shapedirs,
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
