"""Rasterization API (counterpart of gaussianavatar_tpu/ops/rasterize.py):
project (torch ops) -> depth sort + tile binning (torch ops) -> per-tile alpha
blend (CUDA kernel H-fwd, or its plain version for CPU tensors), differentiable
through the CUDA kernel H-bwd (ops/rasterize_tile.BlendTiles).
`rasterize_views` renders B views of precomputed colours; `rasterize`
renders one camera, with precomputed colours or with spherical-harmonics
coefficients (`shs`, `sh_degree`) evaluated from the camera's centre."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gaussianavatar_torch.ops.camera import Camera
from gaussianavatar_torch.ops.projection import ProjectedGaussians, project_gaussians
from gaussianavatar_torch.ops.rasterize_ref import rasterize_brute
from gaussianavatar_torch.ops.rasterize_tile import rasterize_views_binned
from gaussianavatar_torch.ops.sh import sh_to_colors
from gaussianavatar_torch.utils.spans import span


class RasterizeConfig(NamedTuple):
    """The raster settings the port reads. The JAX package's capacity tiers,
    Pallas / XLA backends and gather layouts have no counterpart: the blend
    walks every tile's whole range, or `caps` rows of it."""
    tile_size: int = 32
    max_tiles_per_gaussian: int = 16  # footprint cap M (a perfect square)
    backend: str = "tile"             # "tile" (H-fwd / H-bwd) or "brute" (rasterize_ref)
    # the batch the depth key's bits are budgeted for (0: the batch rendered);
    # a data-parallel rank gives the global batch (ops/rasterize_tile._bin_gaussians)
    key_views: int = 0


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
    caps: Optional[torch.Tensor] = None,  # (B*T,) int32 per-tile row cap
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render B views -> ((B, 3, H, W) image, () int64 overflow). Overflow
    counts the gaussian-tile pairs cut by the footprint cap M and by
    `caps` (the training loop's need table); 0 means nothing was cut.
    `config.backend == "brute"` blends every gaussian at every pixel
    instead (ops/rasterize_ref: tests and tiny scenes; no caps, no
    overflow)."""
    B, N = means3d.shape[:2]
    if rotations.dim() == 2:
        rotations = rotations[None].expand(B, N, 4)
    opacities = opacities.reshape(-1, N)
    if opacities.shape[0] != B:
        opacities = opacities.expand(B, N)
    with span("render::projection", means3d.device):
        projs = project_gaussians(
            means3d, scales, rotations, world_view_transforms, full_proj_transforms,
            tan_fovx, tan_fovy, height, width,
        )
    if config.backend == "brute":
        imgs = [rasterize_brute(ProjectedGaussians(*(x[b] for x in projs)), colors[b],
                                opacities[b], bg_color, height, width) for b in range(B)]
        return torch.stack(imgs), torch.zeros((), dtype=torch.int64, device=means3d.device)
    if config.backend != "tile":
        raise ValueError(f"backend must be tile or brute, got {config.backend!r}")
    return rasterize_views_binned(projs, colors, opacities, bg_color, height, width, config,
                                  caps)


def rasterize(
    means3d: torch.Tensor,             # (N, 3)
    colors: Optional[torch.Tensor],    # (N, 3) in [0, 1], or None with `shs`
    scales: torch.Tensor,              # (N, 3)
    rotations: torch.Tensor,           # (N, 4) wxyz
    opacities: torch.Tensor,           # (N,) or (N, 1)
    camera: Camera,
    bg_color: torch.Tensor,            # (3,)
    scale_modifier: float = 1.0,
    config: RasterizeConfig = RasterizeConfig(),
    shs: Optional[torch.Tensor] = None,  # (N, (sh_degree + 1)^2, 3)
    sh_degree: int = 0,
) -> torch.Tensor:
    """Render one camera -> (3, H, W): `rasterize_views` at B=1 (H-fwd, and
    H-bwd on the way back, with the tile backend). With `shs` the colours
    are max(SH(dir) + 0.5, 0) seen from `camera.camera_center`, and the
    gradient reaches the coefficients through `eval_sh`."""
    if shs is not None:
        colors = sh_to_colors(sh_degree, shs, means3d, camera.camera_center)
    one = lambda t: t.reshape(1, *t.shape)
    img, _ = rasterize_views(one(means3d), one(colors), one(scales * scale_modifier), rotations,
                             opacities.reshape(-1), one(camera.world_view_transform),
                             one(camera.full_proj_transform), one(camera.tan_fovx),
                             one(camera.tan_fovy), camera.height, camera.width, bg_color,
                             config=config)
    return img[0]
