"""POPDecoder (counterpart of gaussianavatar_tpu/models/pop.py), stage 1:

  geometry feature tensor (B, C, F, F)
    -> 'conv' smoother (GeomConvLayers) or none
    -> bilinear upsample to the query UV resolution (`pop_upsample`)
    -> gather the valid UV pixels (the MLP runs on valid points only)
    -> ShapeDecoder -> (offsets, isotropic scales, colors) per point.

The 'bottleneck' and 'unet' smoothers, the stage-2 pose feature map and the
positional encoding of the uv coordinates come with later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gaussianavatar_torch.models.decoder import ShapeDecoder
from gaussianavatar_torch.models.layers import GeomConvLayers
from gaussianavatar_torch.ops.resample import pop_upsample


class POPDecoder(nn.Module):
    def __init__(self, c_geom: int = 64, geom_layer_type: Optional[str] = "conv",
                 hsize: int = 128, compute_dtype: str = "float32"):
        super().__init__()
        if geom_layer_type not in ("conv", None, ""):
            raise NotImplementedError(
                f"geom_layer_type={geom_layer_type!r} is not ported yet (stage-1 'conv' only)")
        self.geom = GeomConvLayers(c_geom, c_geom, c_geom) if geom_layer_type == "conv" else None
        self.decoder = ShapeDecoder(c_geom + 2, hsize=hsize, compute_dtype=compute_dtype)

    def forward(
        self,
        geom_featmap: torch.Tensor,   # (B, C, F, F) NCHW
        uv_coords: torch.Tensor,      # (Nv, 2) normalized uv of the valid pixels
        valid_idx: torch.Tensor,      # (Nv,) int64 flat indices into R*R
        query_res: int,               # R
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.geom is not None:
            geom_featmap = self.geom(geom_featmap)
        B, C = geom_featmap.shape[:2]
        up = pop_upsample(geom_featmap, query_res)                  # (B, C, R, R)
        pts = up.reshape(B, C, query_res * query_res)[:, :, valid_idx].transpose(1, 2)
        uv = uv_coords[None].expand(B, -1, -1)
        return self.decoder(torch.cat([pts, uv], dim=-1))           # (B, Nv, C+2)
