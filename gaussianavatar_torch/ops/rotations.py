"""Rotation conversions (counterpart of gaussianavatar_tpu/ops/rotations.py).

`axis_angle_to_matrix` is the smplx `batch_rodrigues` formula with its
componentwise `norm(v + eps)` regularisation; `quaternion_to_matrix` takes
wxyz quaternions that need not be normalised; `matrix_to_quaternion` picks
the largest of four pivots and returns w >= 0; `matrix_to_axis_angle` goes
through it and `quaternion_to_axis_angle`; `euler_angles_to_matrix` follows
pytorch3d's convention; `normalize` is `F.normalize`'s. Every function
broadcasts over leading dimensions, with the JAX functions' epsilons.
"""

from __future__ import annotations

import torch


def axis_angle_to_matrix(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrix (Rodrigues)."""
    batch_shape = rot_vecs.shape[:-1]
    angle = torch.linalg.norm(rot_vecs + eps, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle

    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]

    rx, ry, rz = rot_dir.unbind(-1)
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(batch_shape + (3, 3))

    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_axis_angle(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) axis-angle, through the
    quaternion (stable near 0 and pi)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(R), eps=eps)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz unit quaternion with w >= 0: of the four
    constructions, the one with the largest pivot (the first on a tie)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    half_sqrt = lambda a: torch.sqrt(torch.clamp(a, min=0.0)) / 2.0
    qw = half_sqrt(1.0 + m00 + m11 + m22)
    qx = half_sqrt(1.0 + m00 - m11 - m22)
    qy = half_sqrt(1.0 - m00 + m11 - m22)
    qz = half_sqrt(1.0 - m00 - m11 + m22)

    def over(q):
        return 4 * q + 1e-12

    c0 = torch.stack([qw, (m21 - m12) / over(qw), (m02 - m20) / over(qw),
                      (m10 - m01) / over(qw)], dim=-1)
    c1 = torch.stack([(m21 - m12) / over(qx), qx, (m01 + m10) / over(qx),
                      (m02 + m20) / over(qx)], dim=-1)
    c2 = torch.stack([(m02 - m20) / over(qy), (m01 + m10) / over(qy), qy,
                      (m12 + m21) / over(qy)], dim=-1)
    c3 = torch.stack([(m10 - m01) / over(qz), (m02 + m20) / over(qz),
                      (m12 + m21) / over(qz), qz], dim=-1)

    best = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)                    # (..., 4, 4)
    index = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, index)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_to_axis_angle(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 4) wxyz unit quaternion -> (..., 3) axis-angle."""
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half, w)
    scale = torch.where(sin_half < eps, 2.0, angle / torch.clamp(sin_half, min=eps))
    return xyz * scale


def euler_angles_to_matrix(angles: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """(..., 3) euler angles -> (..., 3, 3), pytorch3d's convention
    (R = R_first @ R_second @ R_third)."""

    def axis_rot(axis: str, a: torch.Tensor) -> torch.Tensor:
        c, s = torch.cos(a), torch.sin(a)
        one, zero = torch.ones_like(a), torch.zeros_like(a)
        if axis == "X":
            flat = [one, zero, zero, zero, c, -s, zero, s, c]
        elif axis == "Y":
            flat = [c, zero, s, zero, one, zero, -s, zero, c]
        else:
            flat = [c, -s, zero, s, c, zero, zero, zero, one]
        return torch.stack(flat, dim=-1).reshape(a.shape + (3, 3))

    mats = [axis_rot(ax, angles[..., i]) for i, ax in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def normalize(v: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise along `axis` (torch.nn.functional.normalize)."""
    n = torch.linalg.norm(v, dim=axis, keepdim=True)
    return v / torch.clamp(n, min=eps)
