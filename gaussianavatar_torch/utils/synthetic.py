"""Procedural body model (counterpart of gaussianavatar_tpu/utils/synthetic.py).

The official SMPL files are license-gated, so tests, demos and the chip
smoke run use a capsule-like humanoid with the same structural contract as
SMPL: template, blendshapes, joint regressor, kinematic chain, skinning
weights, faces, and a UV atlas with a split vertex/texcoord topology. The
arrays come out bit-identical to the JAX package's for the same arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gaussianavatar_torch.models.body import BodyModel


class UVMesh(NamedTuple):
    """Mesh with a UV atlas (OBJ-style split vertex/texcoord topology)."""

    verts: np.ndarray      # (V, 3)
    uvs: np.ndarray        # (VT, 2) texture coords in [0, 1]
    faces_v: np.ndarray    # (F, 3) vertex indices
    faces_vt: np.ndarray   # (F, 3) texcoord indices


def synthetic_body(
    n_rings: int = 24,
    n_cols: int = 16,
    n_joints: int = 5,
    n_betas: int = 4,
    height: float = 1.6,
    seed: int = 0,
):
    """A tube-shaped 'body' with a joint chain along +y -> (BodyModel on the
    CPU, UVMesh). The UV atlas is a cylindrical unwrap with a duplicated
    seam column."""
    rng = np.random.default_rng(seed)

    ys = np.linspace(0.0, height, n_rings)
    radius = 0.12 * (1.0 + 0.35 * np.sin(np.pi * ys / height))  # waist profile
    theta = np.linspace(0, 2 * np.pi, n_cols, endpoint=False)

    verts = np.zeros((n_rings * n_cols, 3), np.float32)
    for i, (y, r) in enumerate(zip(ys, radius)):
        verts[i * n_cols:(i + 1) * n_cols, 0] = r * np.cos(theta)
        verts[i * n_cols:(i + 1) * n_cols, 1] = y
        verts[i * n_cols:(i + 1) * n_cols, 2] = r * np.sin(theta)
    V = verts.shape[0]

    joint_y = np.linspace(0.0, height, n_joints)
    parents = np.arange(n_joints) - 1
    J_regressor = np.zeros((n_joints, V), np.float32)
    for j, jy in enumerate(joint_y):
        w = np.exp(-((verts[:, 1] - jy) ** 2) / (2 * 0.05**2))
        J_regressor[j] = w / w.sum()

    d = np.abs(verts[:, 1:2] - joint_y[None, :])  # (V, J)
    w = np.exp(-((d / 0.18) ** 2))
    lbs_weights = (w / w.sum(1, keepdims=True)).astype(np.float32)

    # blendshapes: beta0 scales radius, beta1 scales height, rest random small
    shapedirs = rng.normal(scale=0.002, size=(V, 3, n_betas)).astype(np.float32)
    radial = verts.copy()
    radial[:, 1] = 0
    shapedirs[:, :, 0] = radial * 0.3
    shapedirs[:, 1, 1] = verts[:, 1] * 0.1

    posedirs = rng.normal(scale=1e-4, size=(9 * (n_joints - 1), V * 3)).astype(np.float32)

    faces = []
    for i in range(n_rings - 1):
        for c in range(n_cols):
            c2 = (c + 1) % n_cols
            a, b = i * n_cols + c, i * n_cols + c2
            d0, e = (i + 1) * n_cols + c, (i + 1) * n_cols + c2
            faces.append([a, d0, b])
            faces.append([b, d0, e])
    faces = np.asarray(faces, np.int64)

    uvs = np.zeros((n_rings * (n_cols + 1), 2), np.float32)
    margin = 0.04  # keep a border so posmap pixels at the edge stay valid
    for i in range(n_rings):
        for c in range(n_cols + 1):
            uvs[i * (n_cols + 1) + c, 0] = margin + (c / n_cols) * (1 - 2 * margin)
            uvs[i * (n_cols + 1) + c, 1] = margin + (i / (n_rings - 1)) * (1 - 2 * margin)
    faces_vt = []
    for i in range(n_rings - 1):
        for c in range(n_cols):
            a, b = i * (n_cols + 1) + c, i * (n_cols + 1) + c + 1
            d0, e = (i + 1) * (n_cols + 1) + c, (i + 1) * (n_cols + 1) + c + 1
            faces_vt.append([a, d0, b])
            faces_vt.append([b, d0, e])
    faces_vt = np.asarray(faces_vt, np.int64)

    model = BodyModel(
        v_template=torch.as_tensor(verts),
        shapedirs=torch.as_tensor(shapedirs),
        posedirs=torch.as_tensor(posedirs),
        J_regressor=torch.as_tensor(J_regressor),
        lbs_weights=torch.as_tensor(lbs_weights),
        parents=parents.astype(np.int32),
        faces=faces,
        model_type="smpl",
    )
    return model, UVMesh(verts=verts, uvs=uvs, faces_v=faces, faces_vt=faces_vt)


def synthetic_pose(model: BodyModel, t: float, amplitude: float = 0.5) -> np.ndarray:
    """A smooth 'wiggle' pose sequence parameterized by t in [0, 1): each
    joint bends about z with a phase offset."""
    J = model.parents.shape[0]
    pose = np.zeros(J * 3, np.float32)
    for j in range(1, J):
        pose[j * 3 + 2] = amplitude * np.sin(2 * np.pi * t + j * 0.8) / J
    return pose
