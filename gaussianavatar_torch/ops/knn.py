"""K-nearest neighbours and the as-isometric-as-possible (AIAP) loss
(counterpart of gaussianavatar_tpu/ops/knn.py):

  - `grid_knn`: the grid-hash KNN on the device: voxel keys, one stable
    sort, `searchsorted` over the 27 neighbour cells, top-k over a fixed
    budget of candidates;
  - `host_knn`: exact KNN on the host (scipy cKDTree), what training's
    `--use_aiap` builds its neighbour graph with, once at start-up;
  - `aiap_loss`: the L1 discrepancy of neighbour distances between the
    canonical and the deformed points.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# the 27 neighbour-cell offsets, in the JAX package's order
_OFFSETS = [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def grid_knn(points: torch.Tensor, k: int, cell_size: float,
             max_per_cell: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN where the true neighbours lie within one cell of the query
    and cells hold <= max_per_cell points (pick cell_size >= the k-NN
    radius). Cell keys are injective over the data's bounding grid, which
    needs extent / cell_size <~ 1290 per axis to fit int32.

    -> (idx (N, k) int32, dists (N, k)) ascending, self excluded."""
    N = points.shape[0]
    dev = points.device
    cells = torch.floor(points / cell_size).to(torch.int32)
    rel = cells - cells.amin(dim=0)
    dims = rel.amax(dim=0) + 1

    def cell_key(rc):
        ok = ((rc >= 0) & (rc < dims)).all(dim=-1)
        key = (rc[..., 0] * dims[1] + rc[..., 1]) * dims[2] + rc[..., 2]
        return torch.where(ok, key, torch.full_like(key, -1))

    keys = cell_key(rel)
    order = torch.argsort(keys, stable=True)
    sorted_keys = keys[order].contiguous()

    offsets = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)     # (27, 3)
    probe_keys = cell_key(rel[:, None, :] + offsets[None])                # (N, 27)
    starts = torch.searchsorted(sorted_keys, probe_keys)                 # (N, 27) int64
    slot = torch.arange(max_per_cell, device=dev)
    cand_pos = starts[..., None] + slot                                   # (N, 27, C)
    cand_pos_c = cand_pos.clamp(0, N - 1)
    cand_ok = (cand_pos < N) & (sorted_keys[cand_pos_c] == probe_keys[..., None])
    cand_idx = order[cand_pos_c].reshape(N, -1)                           # (N, 27*C)
    cand_ok = cand_ok.reshape(N, -1)

    diff = points[:, None, :] - points[cand_idx]
    d2 = (diff * diff).sum(dim=-1)
    self_mask = cand_idx == torch.arange(N, device=dev)[:, None]
    d2 = torch.where(cand_ok & ~self_mask, d2, torch.full_like(d2, float("inf")))

    neg, top = torch.topk(-d2, k, dim=1)
    idx = torch.gather(cand_idx, 1, top)
    return idx.to(torch.int32), torch.sqrt(torch.clamp_min(-neg, 0.0))


def host_knn(points: np.ndarray, k: int) -> np.ndarray:
    """Exact KNN on the host (scipy cKDTree) -> (N, k) int32 neighbour
    indices, self excluded."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    _, idx = tree.query(points, k=k + 1)
    return idx[:, 1:].astype(np.int32)


def aiap_loss(x_canonical: torch.Tensor, x_deformed: torch.Tensor,
              nn_idx: torch.Tensor) -> torch.Tensor:
    """Mean L1 between canonical and deformed neighbour distances.
    x_*: (..., N, 3); nn_idx: (N, k) neighbour indices."""
    nn_idx = nn_idx.long()

    def dists(x):
        d = x[..., :, None, :] - x[..., nn_idx, :]                  # (..., N, k, 3)
        return torch.sqrt((d * d).sum(dim=-1) + 1e-12)

    return (dists(x_canonical) - dists(x_deformed)).abs().mean()
