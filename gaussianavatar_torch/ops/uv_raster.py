"""Software UV-space rasterizer (host numpy, offline preprocessing).

The port's own copy of gaussianavatar_tpu/ops/uv_raster.py without its
native fast path. A UV atlas has no depth, so barycentric point-in-triangle
coverage over the pixel grid gives the position map, the face-id mask and
the barycentrics that the avatar's preprocessing needs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class UVRaster(NamedTuple):
    position_map: np.ndarray  # (R, R, 3) float32, 0 where background
    face_id: np.ndarray       # (R, R) int32, -1 where background
    bary: np.ndarray          # (R, R, 3) float32 barycentric coords


def rasterize_uv_atlas(
    verts3d: np.ndarray,   # (V, 3) positions to interpolate
    uvs: np.ndarray,       # (VT, 2) texture coords in [0, 1]
    faces_v: np.ndarray,   # (F, 3) indices into verts3d
    faces_vt: np.ndarray,  # (F, 3) indices into uvs
    size: int,
    eps: float = 1e-7,
) -> UVRaster:
    """Rasterize every triangle in UV space at `size`^2 resolution.

    Pixel (r, c) center maps to uv = ((c + .5)/R, (r + .5)/R); u is the
    horizontal axis. Overlapping islands: later faces win."""
    R = size
    pos = np.zeros((R, R, 3), np.float32)
    fid = np.full((R, R), -1, np.int32)
    bar = np.zeros((R, R, 3), np.float32)

    tri_uv = uvs[faces_vt] * R - 0.5   # (F, 3, 2) in pixel units
    tri_3d = verts3d[faces_v]          # (F, 3, 3)

    for f in range(faces_v.shape[0]):
        (x0, y0), (x1, y1), (x2, y2) = tri_uv[f]
        cmin = max(int(np.floor(min(x0, x1, x2))), 0)
        cmax = min(int(np.ceil(max(x0, x1, x2))) + 1, R)
        rmin = max(int(np.floor(min(y0, y1, y2))), 0)
        rmax = min(int(np.ceil(max(y0, y1, y2))) + 1, R)
        if cmin >= cmax or rmin >= rmax:
            continue
        cs, rs = np.meshgrid(np.arange(cmin, cmax), np.arange(rmin, rmax))
        denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(denom) < eps:
            continue
        w0 = ((y1 - y2) * (cs - x2) + (x2 - x1) * (rs - y2)) / denom
        w1 = ((y2 - y0) * (cs - x2) + (x0 - x2) * (rs - y2)) / denom
        w2 = 1.0 - w0 - w1
        inside = (w0 >= -eps) & (w1 >= -eps) & (w2 >= -eps)
        if not inside.any():
            continue
        rr, cc = rs[inside], cs[inside]
        b = np.stack([w0[inside], w1[inside], w2[inside]], -1).astype(np.float32)
        pos[rr, cc] = b @ tri_3d[f]
        bar[rr, cc] = b
        fid[rr, cc] = f
    return UVRaster(position_map=pos, face_id=fid, bary=bar)


def bary_interpolate(
    vert_attrs: np.ndarray,  # (V, C) per-vertex attributes (e.g. lbs weights)
    faces_v: np.ndarray,     # (F, 3)
    raster: UVRaster,
) -> np.ndarray:
    """Interpolate per-vertex attributes onto the UV pixel grid -> (R, R, C);
    background pixels get zeros."""
    R = raster.face_id.shape[0]
    out = np.zeros((R, R, vert_attrs.shape[1]), vert_attrs.dtype)
    mask = raster.face_id >= 0
    fids = raster.face_id[mask]
    tri_attr = vert_attrs[faces_v[fids]]          # (M, 3, C)
    out[mask] = np.einsum("mi,mic->mc", raster.bary[mask], tri_attr)
    return out


def uv_coord_map(size: int) -> np.ndarray:
    """(R*R, 2) normalized (row, col)/(R-1) query coordinates."""
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    idx = np.stack([ys, xs], -1).reshape(-1, 2).astype(np.float32)
    return idx / (size - 1)
