"""Feature-map resampling (counterpart of gaussianavatar_tpu/ops/resample.py):
`grid_sample`, bilinear sampling at normalised coordinates, and the POP
upsampler built on its semantics.

`pop_upsample` reproduces the POP decoder's
`F.grid_sample(pix_feature, uv_to_grid(uv_loc))` exactly, quirks included:
query positions are i/(R-1) over the full UV image, mapped with
align_corners=False pixel math (px = u*F - 0.5) and zero padding outside,
so border queries sample half-weight features. The query set is a full
regular grid, so the sampler collapses to two small dense interpolation
matrices applied as matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def grid_sample(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of NCHW `feat` (B, C, H, W) at `grid` (B, Ho, Wo,
    2), normalised coordinates in [-1, 1] (grid[..., 0] = x, grid[..., 1] =
    y), align_corners=False pixel math, zero outside -> (B, C, Ho, Wo). The
    JAX function takes and returns NHWC; its semantics are defined as this
    call's."""
    return torch.nn.functional.grid_sample(feat, grid, mode="bilinear", padding_mode="zeros",
                                           align_corners=False)


@functools.lru_cache(maxsize=16)
def _interp_matrix(out_res: int, in_res: int) -> np.ndarray:
    """(out_res, in_res) bilinear weights for positions
    p_i = i/(out_res-1)*in_res - 0.5, zero padding outside [0, in_res-1]."""
    pos = np.arange(out_res) / (out_res - 1) * in_res - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    W = np.zeros((out_res, in_res), np.float32)
    for side, wgt in ((lo, 1.0 - frac), (lo + 1, frac)):
        ok = (side >= 0) & (side < in_res)
        W[np.arange(out_res)[ok], side[ok]] += wgt[ok]
    return W


@functools.lru_cache(maxsize=16)
def _interp_matrix_on(out_res: int, in_res: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """`_interp_matrix` on `device`, made once (a CUDA graph of the train
    step cannot capture the host-to-device copy); never written."""
    return torch.as_tensor(_interp_matrix(out_res, in_res), dtype=dtype, device=device)


def pop_upsample(feat: torch.Tensor, out_res: int) -> torch.Tensor:
    """Upsample (B, C, F, F) NCHW features to (B, C, R, R) with the POP
    grid_sample semantics (see module docstring)."""
    B, C, F, F2 = feat.shape
    if F != F2:
        raise ValueError(f"pop_upsample expects square feature maps, got {F}x{F2}")
    if F == out_res:
        return feat
    W = _interp_matrix_on(out_res, F, feat.dtype, feat.device)
    out = torch.einsum("rf,bcfg->bcrg", W, feat)   # rows
    return torch.einsum("sg,bcrg->bcrs", W, out)   # cols
