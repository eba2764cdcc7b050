"""The plain reference's body: a frozen copy of the synthetic tube body that
the benchmark's configurations use, its UV atlas, the UV-space raster that
turns the atlas into query points, skinning weights and posed position
maps, and linear blend skinning.

The body is a tube along +y with a joint chain, SMPL's structural contract
(template, blendshapes, joint regressor, kinematic chain, skinning weights,
faces, a UV atlas with a duplicated seam column). Everything here is numpy
or plain torch and imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Body(NamedTuple):
    v_template: np.ndarray    # (V, 3)
    shapedirs: np.ndarray     # (V, 3, n_betas)
    posedirs: np.ndarray      # (9 (J - 1), 3 V)
    J_regressor: np.ndarray   # (J, V)
    lbs_weights: np.ndarray   # (V, J)
    parents: np.ndarray       # (J,) int, parents[0] = -1
    faces: np.ndarray         # (F, 3) vertex ids
    uvs: np.ndarray           # (VT, 2) texture coordinates in [0, 1]
    faces_vt: np.ndarray      # (F, 3) texture-coordinate ids


def tube_body(n_rings: int, n_cols: int, n_joints: int, n_betas: int, height: float,
              seed: int) -> Body:
    """The tube body: rings of `n_cols` vertices at `n_rings` heights with a
    waist profile, `n_joints` joints along +y, Gaussian skinning weights,
    small random blendshapes from numpy's generator at `seed`, and a
    cylindrical UV unwrap with a 0.04 margin."""
    rng = np.random.default_rng(seed)
    ys = np.linspace(0.0, height, n_rings)
    radius = 0.12 * (1.0 + 0.35 * np.sin(np.pi * ys / height))
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
        w = np.exp(-((verts[:, 1] - jy) ** 2) / (2 * 0.05 ** 2))
        J_regressor[j] = w / w.sum()
    d = np.abs(verts[:, 1:2] - joint_y[None, :])
    w = np.exp(-((d / 0.18) ** 2))
    lbs_weights = (w / w.sum(1, keepdims=True)).astype(np.float32)
    shapedirs = rng.normal(scale=0.002, size=(V, 3, n_betas)).astype(np.float32)
    radial = verts.copy()
    radial[:, 1] = 0
    shapedirs[:, :, 0] = radial * 0.3
    shapedirs[:, 1, 1] = verts[:, 1] * 0.1
    posedirs = rng.normal(scale=1e-4, size=(9 * (n_joints - 1), V * 3)).astype(np.float32)

    faces, faces_vt = [], []
    for i in range(n_rings - 1):
        for c in range(n_cols):
            c2 = (c + 1) % n_cols
            a, b = i * n_cols + c, i * n_cols + c2
            d0, e = (i + 1) * n_cols + c, (i + 1) * n_cols + c2
            faces += [[a, d0, b], [b, d0, e]]
            a, b = i * (n_cols + 1) + c, i * (n_cols + 1) + c + 1
            d0, e = (i + 1) * (n_cols + 1) + c, (i + 1) * (n_cols + 1) + c + 1
            faces_vt += [[a, d0, b], [b, d0, e]]
    uvs = np.zeros((n_rings * (n_cols + 1), 2), np.float32)
    margin = 0.04
    for i in range(n_rings):
        for c in range(n_cols + 1):
            uvs[i * (n_cols + 1) + c, 0] = margin + (c / n_cols) * (1 - 2 * margin)
            uvs[i * (n_cols + 1) + c, 1] = margin + (i / (n_rings - 1)) * (1 - 2 * margin)
    return Body(verts, shapedirs, posedirs, J_regressor, lbs_weights,
                parents.astype(np.int64), np.asarray(faces, np.int64), uvs,
                np.asarray(faces_vt, np.int64))


def wiggle_pose(n_joints: int, t: float, amplitude: float) -> np.ndarray:
    """A smooth pose at phase `t` in [0, 1): joint j bends about z by
    amplitude sin(2 pi t + 0.8 j) / J; the root stays."""
    pose = np.zeros(n_joints * 3, np.float32)
    for j in range(1, n_joints):
        pose[j * 3 + 2] = amplitude * np.sin(2 * np.pi * t + j * 0.8) / n_joints
    return pose


class UVRaster(NamedTuple):
    face_id: np.ndarray   # (R, R) int, -1 off the atlas
    bary: np.ndarray      # (R, R, 3) barycentric weights


def uv_raster(uvs: np.ndarray, faces_vt: np.ndarray, size: int, eps: float = 1e-7) -> UVRaster:
    """Which face covers each pixel of the size^2 UV image, and where:
    pixel (r, c) is at uv ((c + 0.5) / R, (r + 0.5) / R); a pixel inside
    two faces takes the later one."""
    R = size
    fid = np.full((R, R), -1, np.int64)
    bar = np.zeros((R, R, 3), np.float32)
    tri = uvs[faces_vt] * R - 0.5
    for f in range(faces_vt.shape[0]):
        (x0, y0), (x1, y1), (x2, y2) = tri[f]
        cmin, cmax = max(int(np.floor(min(x0, x1, x2))), 0), \
            min(int(np.ceil(max(x0, x1, x2))) + 1, R)
        rmin, rmax = max(int(np.floor(min(y0, y1, y2))), 0), \
            min(int(np.ceil(max(y0, y1, y2))) + 1, R)
        if cmin >= cmax or rmin >= rmax:
            continue
        cs, rs = np.meshgrid(np.arange(cmin, cmax), np.arange(rmin, rmax))
        den = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(den) < eps:
            continue
        w0 = ((y1 - y2) * (cs - x2) + (x2 - x1) * (rs - y2)) / den
        w1 = ((y2 - y0) * (cs - x2) + (x0 - x2) * (rs - y2)) / den
        w2 = 1.0 - w0 - w1
        inside = (w0 >= -eps) & (w1 >= -eps) & (w2 >= -eps)
        if inside.any():
            rr, cc = rs[inside], cs[inside]
            bar[rr, cc] = np.stack([w0[inside], w1[inside], w2[inside]], -1)
            fid[rr, cc] = f
    return UVRaster(fid, bar)


def interpolate(raster: UVRaster, faces: np.ndarray, vert_values: torch.Tensor) -> torch.Tensor:
    """Per-vertex values (..., V, C) -> per-pixel values (..., R*R, C) on the
    atlas (zero off it), with the raster's barycentric weights, in float32."""
    R = raster.face_id.shape[0]
    on = raster.face_id.reshape(-1) >= 0
    dev = vert_values.device
    tri = torch.as_tensor(faces[raster.face_id.reshape(-1)[on]], device=dev)   # (P, 3)
    bary = torch.as_tensor(raster.bary.reshape(-1, 3)[on], device=dev)         # (P, 3)
    vals = (vert_values[..., tri, :] * bary[..., None]).sum(-2)                  # (..., P, C)
    out = vert_values.new_zeros(vert_values.shape[:-2] + (R * R, vert_values.shape[-1]))
    out[..., torch.as_tensor(np.flatnonzero(on), device=dev), :] = vals
    return out


def rodrigues(rv: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3)."""
    angle = torch.linalg.norm(rv + eps, dim=-1, keepdim=True)
    k = rv / angle
    kx, ky, kz = k.unbind(-1)
    z = torch.zeros_like(kx)
    K = torch.stack([z, -kz, ky, kz, z, -kx, -ky, kx, z], -1).reshape(rv.shape[:-1] + (3, 3))
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    return torch.eye(3, dtype=rv.dtype, device=rv.device) + s * K + (1 - c) * (K @ K)


def skin(body: Body, pose: torch.Tensor, transl: torch.Tensor):
    """Pose the body (betas zero): pose (B, 3 J) axis-angle, transl (B, 3)
    -> (vertices (B, V, 3), A (B, J, 4, 4)), the per-joint affines that map
    rest-space points to posed ones, the translation folded in."""
    dev, B = pose.device, pose.shape[0]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    v = t(body.v_template)[None].expand(B, -1, -1)
    J = body.parents.shape[0]
    joints = torch.einsum("bvk,jv->bjk", v, t(body.J_regressor))
    rot = rodrigues(pose.reshape(B, J, 3))
    feat = (rot[:, 1:] - torch.eye(3, device=dev)).reshape(B, -1)
    v_posed = v + (feat @ t(body.posedirs)).reshape(B, -1, 3)
    rel = joints.clone()
    rel[:, 1:] = joints[:, 1:] - joints[:, body.parents[1:]]
    T = torch.zeros((B, J, 4, 4), device=dev)
    T[..., :3, :3] = rot
    T[..., :3, 3] = rel
    T[..., 3, 3] = 1.0
    chain = [T[:, 0]]
    for i in range(1, J):
        chain.append(chain[body.parents[i]] @ T[:, i])
    G = torch.stack(chain, 1)
    jh = torch.cat([joints, torch.zeros_like(joints[..., :1])], -1)
    A = G.clone()
    A[..., :, 3] = G[..., :, 3] - torch.einsum("bjxy,bjy->bjx", G, jh)
    W = torch.einsum("vj,bjpq->bvpq", t(body.lbs_weights), A)
    verts = torch.einsum("bvxy,bvy->bvx", W[..., :3, :3], v_posed) + W[..., :3, 3]
    A = A.clone()
    A[:, :, :3, 3] = A[:, :, :3, 3] + transl[:, None]
    return verts + transl[:, None], A


class Avatar(NamedTuple):
    """The avatar's canonical data, derived from the body and the atlas:
    the valid UV pixels at the query resolution (their flat ids, padded
    with pixel 0 to a multiple of `pad`), their canonical points, skinning
    weights (padding: joint 0) and normalised (row, col) coordinates, and
    the inverse canonical joint affines."""
    valid_idx: torch.Tensor   # (Np,) int64
    points: torch.Tensor      # (Np, 3)
    lbs: torch.Tensor         # (Np, J)
    uv: torch.Tensor          # (Np, 2)
    inv_mats: torch.Tensor    # (J, 4, 4)
    num_valid: int
    res: int


def avatar(body: Body, res: int, pad: int, device) -> Avatar:
    """The canonical avatar at query resolution `res` (canonical pose zero,
    betas zero, no translation)."""
    raster = uv_raster(body.uvs, body.faces_vt, res)
    J = body.parents.shape[0]
    zero = torch.zeros((1, 3 * J), device=device)
    verts, A = skin(body, zero, torch.zeros((1, 3), device=device))
    pos = interpolate(raster, body.faces, verts)[0]
    lbs = interpolate(raster, body.faces, torch.as_tensor(body.lbs_weights, device=device))
    valid = torch.as_tensor(np.flatnonzero(raster.face_id.reshape(-1) >= 0), device=device)
    n = valid.shape[0]
    n_pad = (-n) % pad
    ys, xs = valid // res, valid % res
    uv = torch.stack([ys, xs], -1).float() / (res - 1)
    pad_lbs = torch.zeros((n_pad, J), device=device)
    pad_lbs[:, 0] = 1.0
    return Avatar(
        valid_idx=torch.cat([valid, valid.new_zeros(n_pad)]),
        points=torch.cat([pos[valid], pos.new_zeros((n_pad, 3))]),
        lbs=torch.cat([lbs[valid], pad_lbs]),
        uv=torch.cat([uv, uv.new_zeros((n_pad, 2))]),
        inv_mats=torch.linalg.inv(A[0]),
        num_valid=n, res=res)


def posmaps(body: Body, raster: UVRaster, pose: torch.Tensor, transl: torch.Tensor) -> torch.Tensor:
    """Posed position maps (B, 3, S, S) of the body at the raster's size:
    the posed vertices interpolated over the atlas, zero off it."""
    verts, _ = skin(body, pose, transl)
    S = raster.face_id.shape[0]
    return interpolate(raster, body.faces, verts).reshape(-1, S, S, 3).permute(0, 3, 1, 2)


def place(av: Avatar, A: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Canonical points + offsets (B, Np, 3) skinned by the frames' joint
    affines A (B, J, 4, 4) -> world points (B, Np, 3)."""
    m = torch.einsum("nj,bjpq->bnpq", av.lbs, A @ av.inv_mats[None])
    p = av.points[None] + offsets
    return torch.einsum("bnpq,bnq->bnp", m[..., :3, :3], p) + m[..., :3, 3]
