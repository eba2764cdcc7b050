"""Rotation conversions (counterpart of gaussianavatar_tpu/ops/rotations.py).

`axis_angle_to_matrix` is the smplx `batch_rodrigues` formula with its
componentwise `norm(v + eps)` regularisation; `quaternion_to_matrix` takes
wxyz quaternions that need not be normalised. Both broadcast over leading
dimensions.
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
