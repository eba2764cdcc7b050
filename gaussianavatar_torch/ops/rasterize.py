"""Batched rasterization API (counterpart of gaussianavatar_tpu/ops/rasterize.py):
project (torch ops) -> depth sort + tile binning (torch ops) -> per-tile alpha
blend (CUDA kernel H-fwd, or its plain version for CPU tensors), differentiable
through the CUDA kernel H-bwd (ops/rasterize_tile.BlendTiles)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.profiler import record_function

from gaussianavatar_torch.ops.projection import project_gaussians
from gaussianavatar_torch.ops.rasterize_tile import rasterize_views_binned


class RasterizeConfig(NamedTuple):
    """The raster settings the port reads. The JAX package's capacity tiers,
    backends and gather layouts have no counterpart: the blend walks every
    tile's whole range, or `caps` rows of it."""
    tile_size: int = 32
    max_tiles_per_gaussian: int = 16  # footprint cap M (a perfect square)


def raster_config(cfg, train: bool = False) -> RasterizeConfig:
    """The raster settings of a Config (gaussianavatar_torch.config): tile
    size and the footprint cap M, `max_tiles_per_gaussian` (9) for training
    and `render_max_tiles_per_gaussian` (4; 0 = the training value) for
    rendering, as the JAX package's engine/loop.raster_config(train=)."""
    r = cfg.raster
    M = r.max_tiles_per_gaussian if train else \
        (r.render_max_tiles_per_gaussian or r.max_tiles_per_gaussian)
    return RasterizeConfig(tile_size=r.tile_size, max_tiles_per_gaussian=M)


def rasterize_views(
    means3d: torch.Tensor,                # (B, N, 3)
    colors: torch.Tensor,                 # (B, N, 3)
    scales: torch.Tensor,                 # (B, N, 3)
    rotations: torch.Tensor,              # (N, 4) shared or (B, N, 4)
    opacities: torch.Tensor,              # (N,) shared or (B, N)
    world_view_transforms: torch.Tensor,  # (B, 4, 4)
    full_proj_transforms: torch.Tensor,   # (B, 4, 4)
    tan_fovx: torch.Tensor,               # (B,)
    tan_fovy: torch.Tensor,               # (B,)
    height: int,
    width: int,
    bg_color: torch.Tensor,               # (3,)
    config: RasterizeConfig = RasterizeConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render B views -> ((B, 3, H, W) image, () int64 overflow). Overflow
    counts the gaussian-tile pairs cut by the footprint cap M; 0 means
    nothing was cut."""
    B, N = means3d.shape[:2]
    if rotations.dim() == 2:
        rotations = rotations[None].expand(B, N, 4)
    opacities = opacities.reshape(-1, N)
    if opacities.shape[0] != B:
        opacities = opacities.expand(B, N)
    with record_function("render::projection"):
        projs = project_gaussians(
            means3d, scales, rotations, world_view_transforms, full_proj_transforms,
            tan_fovx, tan_fovy, height, width,
        )
    return rasterize_views_binned(projs, colors, opacities, bg_color, height, width, config)
