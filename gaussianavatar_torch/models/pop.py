"""POPDecoder (counterpart of gaussianavatar_tpu/models/pop.py):

  geometry feature tensor (B, C, F, F)
    -> smoother: 'conv' (GeomConvLayers), 'bottleneck'
       (GeomConvBottleneckLayers), 'unet' (UnetNoCond5DS) or none
    -> + the pose feature map (stage 2)
    -> bilinear upsample to the query UV resolution (`pop_upsample`)
    -> gather the valid UV pixels (the MLP runs on valid points only)
    -> + their uv coordinates, NeRF-encoded with `pos_encoding`
       (`num_emb_freqs` frequencies, the raw uv too with `posemb_incl_input`)
    -> ShapeDecoder, or ShapeDecoderFused with decoder_impl="fused"
       -> (offsets, isotropic scales, colors) per point.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gaussianavatar_torch.models.decoder import ShapeDecoder, ShapeDecoderFused
from gaussianavatar_torch.models.layers import (
    GeomConvBottleneckLayers, GeomConvLayers, UnetNoCond5DS,
)
from gaussianavatar_torch.ops.embedder import get_embedder
from gaussianavatar_torch.ops.resample import pop_upsample


def _smoother(kind: Optional[str], c_geom: int, nf: int, up_mode: str, use_dropout: bool,
              generator: Optional[torch.Generator]) -> Optional[nn.Module]:
    if kind == "conv":
        return GeomConvLayers(c_geom, c_geom, c_geom)
    if kind == "bottleneck":
        return GeomConvBottleneckLayers(c_geom, c_geom, c_geom)
    if kind == "unet":
        return UnetNoCond5DS(c_geom, c_geom, nf, up_mode, use_dropout, generator=generator)
    if kind in (None, ""):
        return None
    raise ValueError(f"geom_layer_type must be conv, bottleneck, unet or none, got {kind!r}")


class POPDecoder(nn.Module):
    def __init__(self, c_geom: int = 64, geom_layer_type: Optional[str] = "conv",
                 nf: int = 32, hsize: int = 128, up_mode: str = "upconv",
                 use_dropout: bool = False, pos_encoding: bool = False,
                 num_emb_freqs: int = 6, posemb_incl_input: bool = False,
                 compute_dtype: str = "float32", decoder_impl: str = "ref",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if decoder_impl not in ("ref", "fused"):
            raise ValueError(f"decoder_impl must be ref or fused, got {decoder_impl!r}")
        self.geom = _smoother(geom_layer_type, c_geom, nf, up_mode, use_dropout, generator)
        # the uv coordinates: 2 channels, or 2 (2 m + incl) encoded
        self.embed, uv_dim = get_embedder(num_emb_freqs if pos_encoding else 0, input_dims=2,
                                          include_input=bool(posemb_incl_input))
        decoder = ShapeDecoderFused if decoder_impl == "fused" else ShapeDecoder
        self.decoder = decoder(c_geom + uv_dim, hsize=hsize, compute_dtype=compute_dtype)

    def forward(
        self,
        geom_featmap: torch.Tensor,   # (B, C, F, F) NCHW
        uv_coords: torch.Tensor,      # (Nv, 2) normalized uv of the valid pixels
        valid_idx: torch.Tensor,      # (Nv,) int64 flat indices into R*R
        query_res: int,               # R
        pose_featmap: Optional[torch.Tensor] = None,  # (B, C, F, F), stage 2
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.geom is not None:
            geom_featmap = self.geom(geom_featmap)
        if pose_featmap is not None:
            geom_featmap = geom_featmap + pose_featmap
        B, C = geom_featmap.shape[:2]
        up = pop_upsample(geom_featmap, query_res)                  # (B, C, R, R)
        pts = up.reshape(B, C, query_res * query_res)[:, :, valid_idx].transpose(1, 2)
        uv = self.embed(uv_coords)[None].expand(B, -1, -1)
        return self.decoder(torch.cat([pts, uv], dim=-1))           # (B, Nv, C+uv)
