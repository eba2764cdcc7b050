"""Local-frame transforms for POP-style pipelines (counterpart of
gaussianavatar_tpu/ops/local_frames.py): per-UV-pixel frames of a posed
mesh and barycentric interpolation of per-vertex transforms and skinning
weights onto the UV grid. The GaussianAvatar path predicts canonical
offsets and does not call them; they serve variants that predict offsets
in per-triangle frames. The interpolations run in float32, as the JAX
package's HIGHEST-precision einsums do."""

from __future__ import annotations

import torch


def gen_transf_mtx_full_uv(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """verts (B, V, 3), faces (R, R, 3) per-pixel vertex ids -> (B, R, R, 3,
    3) whose columns are [uu, vv, ww]: the two triangle edges and the unit
    normal scaled by the mean edge length (not orthonormal)."""
    tris = verts[:, faces.long()]  # (B, R, R, 3, 3)
    v1, v2, v3 = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
    uu = v2 - v1
    vv = v3 - v1
    ww_raw = torch.linalg.cross(uu, vv, dim=-1)
    ww = ww_raw / torch.clamp_min(torch.linalg.vector_norm(ww_raw, dim=-1, keepdim=True), 1e-12)
    ww_norm = (torch.linalg.vector_norm(uu, dim=-1).mean(dim=(-1, -2))
               + torch.linalg.vector_norm(vv, dim=-1).mean(dim=(-1, -2))) / 2.0
    ww = ww * ww_norm[:, None, None, None]
    return torch.stack([uu, vv, ww], dim=-1)


def gen_transf_mtx_from_vtransf(vtransf: torch.Tensor, bary_coords: torch.Tensor,
                                faces: torch.Tensor, scaling: float = 1.0) -> torch.Tensor:
    """vtransf (B, V, 3, 3), bary_coords (R, R, 3), faces (R, R, 3) ->
    (B, R, R, 3, 3): each pixel's vertex transforms weighted by its
    barycentric coordinates, times `scaling`."""
    tri_tf = vtransf[:, faces.long()].float()  # (B, R, R, 3, 3, 3)
    out = torch.einsum("bpqijk,pqi->bpqjk", tri_tf, bary_coords.float())
    return out * scaling


def gen_lbs_weight_from_ori(lbs_weights: torch.Tensor, bary_coords: torch.Tensor,
                            faces: torch.Tensor) -> torch.Tensor:
    """lbs_weights (V, J), bary_coords (R, R, 3), faces (R, R, 3) -> (R, R,
    J): the skinning weights interpolated onto the UV grid."""
    tri_w = lbs_weights[faces.long()].float()  # (R, R, 3, J)
    return torch.einsum("pqik,pqi->pqk", tri_w, bary_coords.float())
