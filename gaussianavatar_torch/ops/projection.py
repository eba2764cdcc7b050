"""EWA projection of 3D Gaussians to screen space (counterpart of
gaussianavatar_tpu/ops/projection.py), batched over views.

Semantics of the CUDA `diff-gaussian-rasterization` preprocess stage:
  - row-vector transforms (x_clip = [x, 1] @ full_proj_transform),
  - frustum culling at view-space z <= 0.2,
  - 3D covariance R S S^T R^T from quaternion + per-axis scales,
  - EWA Jacobian with the 1.3*tan_fov clamp on view-space x/y,
  - +0.3 screen-space dilation on the 2D covariance diagonal,
  - radius = ceil(3 * sqrt(max eigenvalue)), NDC -> pixel ((v+1)*S-1)/2.

Differentiable in means and scales (and rotations) through means2d and the
conics, with the gradient of `jax.grad` of the JAX function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianavatar_torch.ops.rotations import quaternion_to_matrix


def compute_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """(..., 3) scales + (..., 4) wxyz quaternions -> (..., 3, 3) covariance
    R S S^T R^T."""
    R = quaternion_to_matrix(rotations)
    M = R * (scales * scale_modifier)[..., None, :]  # columns scaled: R @ diag(S)
    return M @ M.transpose(-1, -2)


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor   # (B, N, 2) pixel coords
    depths: torch.Tensor    # (B, N) view-space z
    conics: torch.Tensor    # (B, N, 3) inverse 2D covariance (a, b, c)
    radii: torch.Tensor     # (B, N) float screen-space radius (0 = culled)


def project_gaussians(
    means3d: torch.Tensor,               # (B, N, 3)
    scales: torch.Tensor,                # (B, N, 3)
    rotations: torch.Tensor,             # (B, N, 4) wxyz
    world_view_transform: torch.Tensor,  # (B, 4, 4)
    full_proj_transform: torch.Tensor,   # (B, 4, 4)
    tan_fovx: torch.Tensor,              # (B,)
    tan_fovy: torch.Tensor,              # (B,)
    height: int,
    width: int,
) -> ProjectedGaussians:
    """Project B views of N gaussians; culled gaussians get radius 0."""
    ones = torch.ones_like(means3d[..., :1])
    p_hom4 = torch.cat([means3d, ones], dim=-1)           # (B, N, 4)

    p_view = p_hom4 @ world_view_transform                # row-vector convention
    depths = p_view[..., 2]

    p_clip = p_hom4 @ full_proj_transform
    p_w = 1.0 / (p_clip[..., 3] + 1e-7)
    p_proj = p_clip[..., :3] * p_w[..., None]

    in_frustum = depths > 0.2

    # EWA: view-space point with the fov clamp
    tx, ty, tz = p_view[..., 0], p_view[..., 1], p_view[..., 2]
    tz_safe = torch.where(tz.abs() < 1e-8, torch.full_like(tz, 1e-8), tz)
    limx = (1.3 * tan_fovx)[:, None]
    limy = (1.3 * tan_fovy)[:, None]
    # jnp.clip is maximum-then-minimum, and both split the gradient evenly at
    # a tie; torch.maximum / minimum do the same (torch.clamp passes it whole)
    txtz = torch.minimum(torch.maximum(tx / tz_safe, -limx), limx)
    tytz = torch.minimum(torch.maximum(ty / tz_safe, -limy), limy)
    tx = txtz * tz_safe
    ty = tytz * tz_safe

    focal_x = (width / (2.0 * tan_fovx))[:, None]
    focal_y = (height / (2.0 * tan_fovy))[:, None]

    j00 = focal_x / tz_safe
    j02 = -(focal_x * tx) / (tz_safe * tz_safe)
    j11 = focal_y / tz_safe
    j12 = -(focal_y * ty) / (tz_safe * tz_safe)

    W = world_view_transform[:, :3, :3].transpose(1, 2)[:, None]  # (B,1,3,3) view rotation

    R = quaternion_to_matrix(rotations)                     # (B, N, 3, 3)
    RS = R * scales[..., None, :]                           # columns scaled
    # rows of M = J @ W: m0 = j00*W[0] + j02*W[2]; m1 = j11*W[1] + j12*W[2]
    m0 = j00[..., None] * W[..., 0, :] + j02[..., None] * W[..., 2, :]   # (B, N, 3)
    m1 = j11[..., None] * W[..., 1, :] + j12[..., None] * W[..., 2, :]
    B0 = (m0[..., :, None] * RS).sum(dim=-2)                # (B, N, 3)
    B1 = (m1[..., :, None] * RS).sum(dim=-2)
    cxx = (B0 * B0).sum(-1) + 0.3
    cyy = (B1 * B1).sum(-1) + 0.3
    cxy = (B0 * B1).sum(-1)

    det = cxx * cyy - cxy * cxy
    det_valid = det > 0.0
    det_safe = torch.where(det_valid, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conics = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)

    mid = 0.5 * (cxx + cyy)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det_safe, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    mean_x = ((p_proj[..., 0] + 1.0) * width - 1.0) * 0.5
    mean_y = ((p_proj[..., 1] + 1.0) * height - 1.0) * 0.5
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    valid = in_frustum & det_valid
    radii = torch.where(valid, radius, torch.zeros_like(radius))
    # radii and depths only bin (tile rects, sort keys): they carry no gradient
    return ProjectedGaussians(means2d=means2d, depths=depths.detach(), conics=conics,
                              radii=radii.detach())
