"""Tile-binned Gaussian splatting (counterpart of
gaussianavatar_tpu/ops/rasterize_tile.py).

Pipeline for a batch of B views:
  1. binning (`_bin_gaussians`, torch ops): each gaussian emits up to
     M = MW*MH (tile, depth) keys; one sort of the B*N*M keys groups them by
     tile in depth order; a searchsorted pass yields per-tile offsets,
  2. the alpha blend (`blend_tiles`): the hand-written CUDA kernel H-fwd
     (`csrc/blend_fwd.cu`) walks each tile's whole depth-sorted range, or
     takes an optional per-tile cap. Its plain PyTorch version
     `blend_tiles_plain` computes the same function and serves CPU tensors.

The JAX package blends at most K rows per tile (capacity tiers) because a
TPU kernel needs static shapes; the port has no capacities. The footprint
cap M stays: a gaussian covers at most MW x MH tiles, and every clipped
(gaussian, tile) pair is counted in the reported overflow.

Sorting is always stable: ties of (tile, depth key) blend in gaussian-index
order, through one sort of the 64-bit key (key << 32) | row.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from gaussianavatar_torch.ops.projection import ProjectedGaussians
from gaussianavatar_torch.ops.rasterize_ref import ALPHA_MIN, T_EPS, blend_pixels, gate_terms

_INT32_MAX = 2**31 - 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BinContext(NamedTuple):
    """Sorted gaussian-tile key table for one batch of views."""
    offsets: torch.Tensor      # (B*T+1,) int32: tile t owns sorted rows [offsets[t], offsets[t+1])
    sorted_vals: torch.Tensor  # (B*N*M,) int32 flat gaussian ids in (tile, depth) order
    packed: torch.Tensor       # (B*N, 16) per-gaussian rows: mx,my|a,b,c|r,g,b|op|valid|pad
    full_counts: torch.Tensor  # (B*T,) int32 gaussians per tile
    m_dropped: torch.Tensor    # () int64 gaussian-tile pairs cut by the MW*MH footprint cap


def _footprint_rects(mx, r, v, ts, txn, tyn, MW, MH):
    """Capped tile rects for every gaussian: (x0, y0, spanx, spany,
    m_dropped). The rect is CUDA getRect's ([min, max) clamped to the grid);
    footprints wider than MW x MH tiles are recentered on the mean's tile and
    clipped, and every clipped valid pair is counted in `m_dropped`."""
    i32 = torch.int32
    x0 = torch.clamp(torch.floor((mx[..., 0] - r) / ts), 0, txn).to(i32)
    x1 = torch.clamp(torch.floor((mx[..., 0] + r + ts - 1) / ts), 0, txn).to(i32)
    y0 = torch.clamp(torch.floor((mx[..., 1] - r) / ts), 0, tyn).to(i32)
    y1 = torch.clamp(torch.floor((mx[..., 1] + r + ts - 1) / ts), 0, tyn).to(i32)

    # the mean's tile, clamped into the rect (in float, before the int cast)
    cxt = torch.clamp(torch.floor(mx[..., 0] / ts), x0.float(),
                      torch.maximum(x1 - 1, x0).float()).to(i32)
    cyt = torch.clamp(torch.floor(mx[..., 1] / ts), y0.float(),
                      torch.maximum(y1 - 1, y0).float()).to(i32)
    spanx = x1 - x0
    spany = y1 - y0
    raw_area = spanx * spany
    x0 = torch.where(spanx > MW, torch.clamp(cxt - MW // 2, x0, x1 - MW), x0)
    y0 = torch.where(spany > MH, torch.clamp(cyt - MH // 2, y0, y1 - MH), y0)
    spanx = torch.clamp_max(spanx, MW)
    spany = torch.clamp_max(spany, MH)
    m_dropped = torch.where(v, raw_area - spanx * spany, torch.zeros_like(raw_area)).sum()
    return x0, y0, spanx, spany, m_dropped


def depth_key_bits(n_tiles_total: int) -> int:
    """Depth bits under the tile field so (B*T) << bits fits int31: 28 at
    small tile counts, 18 at 4 views x 1024 tiles. The JAX package uses the
    same rule; a wider key would order ties differently from it."""
    depth_bits = 28
    while n_tiles_total << depth_bits >= 2**31 and depth_bits > 8:
        depth_bits -= 1
    if n_tiles_total << depth_bits >= 2**31:
        raise ValueError(f"too many tiles ({n_tiles_total}) for int32 keys")
    return depth_bits


def _bin_gaussians(
    projs: ProjectedGaussians,   # batched (B, N, ...) fields
    colors: torch.Tensor,        # (B, N, 3)
    opacities: torch.Tensor,     # (B, N)
    height: int,
    width: int,
    ts: int,
    MW: int,
    MH: int,
) -> BinContext:
    """Bin a whole batch with ONE sort. Key: ((b*T + tile) << depth_bits) |
    depth_quant, the top depth_bits of the positive float pattern of the
    depth (monotone); the row index breaks ties."""
    B, N = projs.depths.shape
    txn, tyn = _cdiv(width, ts), _cdiv(height, ts)
    T = txn * tyn
    M = MW * MH
    dev = projs.depths.device
    depth_bits = depth_key_bits(B * T)

    ops = opacities.reshape(B, N)
    # opacity < 1/255 can never pass the alpha floor: drop at binning (this is
    # how padding gaussians with opacity 0 become free)
    v = (projs.radii > 0) & (ops >= ALPHA_MIN)
    mx = projs.means2d
    x0, y0, spanx, spany, m_dropped = _footprint_rects(
        mx, projs.radii, v, ts, txn, tyn, MW, MH)

    depth_key = torch.clamp_min(projs.depths, 1e-6).contiguous().view(torch.int32) \
        >> (32 - depth_bits)

    # slot-major (M, B, N) layout, as in the JAX package
    slots = torch.arange(M, dtype=torch.int32, device=dev)
    sx = (slots % MW)[:, None, None]
    sy = (slots // MW)[:, None, None]
    tile_x = x0[None] + sx
    tile_y = y0[None] + sy
    slot_valid = v[None] & (sx < spanx[None]) & (sy < spany[None])
    img_off = (torch.arange(B, dtype=torch.int32, device=dev) * T)[None, :, None]
    tile_id = img_off + tile_y * txn + tile_x
    keys = torch.where(slot_valid, (tile_id << depth_bits) | depth_key[None],
                       torch.full_like(tile_id, _INT32_MAX))
    rows = (torch.arange(B, dtype=torch.int64, device=dev) * N)[:, None] \
        + torch.arange(N, dtype=torch.int64, device=dev)[None, :]
    # one sort of the 64-bit (key, row) pair: stable by construction
    combined = (keys.to(torch.int64) << 32) | rows[None]
    sorted_comb = torch.sort(combined.reshape(-1)).values
    sorted_keys = sorted_comb >> 32
    sorted_vals = (sorted_comb & 0xFFFFFFFF).to(torch.int32)

    boundaries = torch.arange(B * T + 1, dtype=torch.int64, device=dev) << depth_bits
    offsets = torch.searchsorted(sorted_keys, boundaries, side="left").to(torch.int32)
    full_counts = offsets[1:] - offsets[:-1]

    packed = torch.cat(
        [
            mx.reshape(B * N, 2),
            projs.conics.reshape(B * N, 3),
            colors.reshape(B * N, 3),
            ops.reshape(B * N, 1),
            torch.ones((B * N, 1), dtype=mx.dtype, device=dev),  # valid
            torch.zeros((B * N, 6), dtype=mx.dtype, device=dev),
        ],
        dim=-1,
    )
    return BinContext(offsets=offsets, sorted_vals=sorted_vals, packed=packed.contiguous(),
                      full_counts=full_counts, m_dropped=m_dropped)


# --------------------------------------------------------------------------
# The blend: CUDA kernel H-fwd and its plain PyTorch version
# --------------------------------------------------------------------------

def _tile_groups(packed, sorted_vals, offsets, counts, txn, ts, n_tiles, max_elems):
    """Groups of tiles with rows to blend, deepest first, each small enough
    that its (tiles x rows x pixels) temporaries stay under `max_elems`
    elements. Yields (tiles (S,), px, py (S, ts*ts) pixel coordinates,
    rows (S, K, 16) gathered in depth order, in_range (S, K) bool)."""
    dev = packed.device
    f = torch.arange(ts * ts, device=dev)
    lpx, lpy = f % ts, f // ts
    L = sorted_vals.shape[0]
    counts_host = counts.cpu()
    order = torch.argsort(counts_host, descending=True, stable=True)
    order = order[counts_host[order] > 0]
    i = 0
    while i < order.shape[0]:
        K = int(counts_host[order[i]])
        S = max(1, max_elems // (K * ts * ts))
        tiles = order[i:i + S].to(dev)
        i += S
        ks = torch.arange(K, device=dev)
        idx = offsets[tiles].to(torch.int64)[:, None] + ks[None]
        in_range = ks[None] < counts[tiles][:, None]
        rows = packed[sorted_vals[idx.clamp(max=L - 1)].to(torch.int64)]
        local = tiles % n_tiles
        px = ((local % txn) * ts)[:, None] + lpx[None]
        py = ((local // txn) * ts)[:, None] + lpy[None]
        yield tiles, px.float(), py.float(), rows, in_range


def _capped_counts(offsets, caps):
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    if caps is not None:
        counts = torch.minimum(counts, caps.to(torch.int64).clamp_min(0))
    return counts


def blend_tiles_plain(
    packed: torch.Tensor,        # (B*N, 16) f32
    sorted_vals: torch.Tensor,   # (L,) int32 gaussian ids in (tile, depth) order
    offsets: torch.Tensor,       # (G+1,) int32
    txn: int,
    ts: int,
    n_tiles: int,
    caps: Optional[torch.Tensor] = None,  # (G,) int32 per-tile row cap
    max_elems: int = 1 << 24,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of H-fwd, the same signature and outputs:
    premultiplied color (G, 3, ts*ts), final T (G, ts*ts), n_contrib
    (G, ts*ts) int32, done (G, ts*ts) f32. Per group of tiles it gathers the
    rows and runs the dense `blend_pixels` form; tiles are grouped deepest
    first so a group's (tiles x rows x pixels) temporaries stay under
    `max_elems` elements."""
    G = offsets.shape[0] - 1
    PX = ts * ts
    dev = packed.device
    counts = _capped_counts(offsets, caps)
    color = torch.zeros((G, 3, PX), dtype=torch.float32, device=dev)
    T_out = torch.ones((G, PX), dtype=torch.float32, device=dev)
    ncon = torch.zeros((G, PX), dtype=torch.int32, device=dev)
    done = torch.zeros((G, PX), dtype=torch.float32, device=dev)
    for tiles, px, py, rows, in_range in _tile_groups(packed, sorted_vals, offsets, counts,
                                                      txn, ts, n_tiles, max_elems):
        active = in_range & (rows[..., 9] > 0)
        c, t, n, d = blend_pixels(px, py, rows[..., 0:2], rows[..., 2:5],
                                  rows[..., 5:8], rows[..., 8], active)
        color[tiles] = c.transpose(1, 2)
        T_out[tiles] = t
        ncon[tiles] = n
        done[tiles] = d.float()
    return color, T_out, ncon, done


def blend_walk_counts(
    packed: torch.Tensor,
    sorted_vals: torch.Tensor,
    offsets: torch.Tensor,
    txn: int,
    ts: int,
    n_tiles: int,
    caps: Optional[torch.Tensor] = None,
    max_elems: int = 1 << 24,
) -> dict:
    """The (row, pixel) pairs H-fwd walks on these inputs, by how each ends:
    `cut_power` (power > 0), `cut_alpha` (alpha < 1/255), `terminating` (the
    row that would take T below 1e-4, one per done pixel) and `blended`. A
    pixel walks its tile's rows in depth order up to its terminating row, or
    all of them. Arguments as `blend_tiles_plain`; used to bound the kernel's
    work, nowhere on the render path."""
    counts = _capped_counts(offsets, caps)
    tot = dict.fromkeys(("cut_power", "cut_alpha", "terminating", "blended"), 0)
    for _, px, py, rows, in_range in _tile_groups(packed, sorted_vals, offsets, counts,
                                                  txn, ts, n_tiles, max_elems):
        # the kernel gives an invalid row opacity 0
        opac = torch.where(rows[..., 9] > 0, rows[..., 8], torch.zeros_like(rows[..., 8]))
        power, alpha = gate_terms(px, py, rows[..., 0:2], rows[..., 2:5], opac)
        cut_power = power > 0.0
        passed = ~cut_power & (alpha >= ALPHA_MIN)
        one_minus = torch.where(passed, 1.0 - alpha, torch.ones_like(alpha))
        T_incl = torch.cumprod(one_minus, dim=-2)
        T_before = torch.cat([torch.ones_like(T_incl[..., :1, :]), T_incl[..., :-1, :]], dim=-2)
        trigger = passed & (T_before * one_minus < T_EPS)
        fired = torch.cumsum(trigger.to(torch.int32), dim=-2)  # triggers up to this row
        walked = in_range[..., None] & (fired - trigger.to(torch.int32) == 0)
        tot["cut_power"] += int((walked & cut_power).sum())
        tot["cut_alpha"] += int((walked & ~cut_power & ~passed).sum())
        tot["terminating"] += int((walked & trigger).sum())
        tot["blended"] += int((walked & passed & ~trigger).sum())
    return tot


def _check(name, t, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"blend_tiles: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"blend_tiles: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"blend_tiles: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"blend_tiles: {name} must be contiguous")


def blend_tiles(
    packed: torch.Tensor,
    sorted_vals: torch.Tensor,
    offsets: torch.Tensor,
    txn: int,
    ts: int,
    n_tiles: int,
    caps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tile blend. CUDA tensors launch the H-fwd kernel (built from
    `csrc/blend_fwd.cu` on first use) on the current stream; CPU tensors, and
    only they, take `blend_tiles_plain`. Outputs as `blend_tiles_plain`.
    Each launch adds one to `cuda_build.LAUNCHES["blend_fwd"]`."""
    if packed.device.type == "cpu":
        return blend_tiles_plain(packed, sorted_vals, offsets, txn, ts, n_tiles, caps)
    from gaussianavatar_torch.utils.cuda_build import LAUNCHES, load_library

    lib = load_library("blend_fwd")
    G = offsets.shape[0] - 1
    PX = ts * ts
    if not 0 < PX <= 1024:
        raise ValueError(f"blend_tiles: tile size {ts} needs 1 to 1024 pixels per tile")
    _check("packed", packed, torch.float32)
    if packed.dim() != 2 or packed.shape[1] != 16:
        raise ValueError(f"blend_tiles: packed must be (rows, 16), got {tuple(packed.shape)}")
    _check("sorted_vals", sorted_vals, torch.int32)
    _check("offsets", offsets, torch.int32, (G + 1,))
    if caps is not None:
        _check("caps", caps, torch.int32, (G,))
    dev = packed.device
    color = torch.empty((G, 3, PX), dtype=torch.float32, device=dev)
    T_out = torch.empty((G, PX), dtype=torch.float32, device=dev)
    ncon = torch.empty((G, PX), dtype=torch.int32, device=dev)
    done = torch.empty((G, PX), dtype=torch.float32, device=dev)
    fn = lib.ga_blend_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(packed.data_ptr(), sorted_vals.data_ptr(), offsets.data_ptr(),
            caps.data_ptr() if caps is not None else None,
            G, n_tiles, txn, ts,
            color.data_ptr(), T_out.data_ptr(), ncon.data_ptr(), done.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["blend_fwd"] += 1
    return color, T_out, ncon, done


def _untile(x: torch.Tensor, txn: int, tyn: int, ts: int, height: int, width: int) -> torch.Tensor:
    """(T, C, ts*ts) tile-major -> (C, H, W)."""
    C = x.shape[1]
    x = x.reshape(tyn, txn, C, ts, ts)
    return x.permute(2, 0, 3, 1, 4).reshape(C, tyn * ts, txn * ts)[:, :height, :width]


def rasterize_views_binned(
    projs: ProjectedGaussians,   # batched: every field has leading dim B
    colors: torch.Tensor,        # (B, N, 3)
    opacities: torch.Tensor,     # (B, N)
    bg: torch.Tensor,            # (3,)
    height: int,
    width: int,
    config,
    caps: Optional[torch.Tensor] = None,  # (B*T,) per-tile row cap
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a batch of views -> ((B, 3, H, W) image, () overflow: the
    gaussian-tile pairs dropped by the footprint cap and by `caps`; 0 means
    every binned pair was blendable)."""
    ts = config.tile_size
    M = config.max_tiles_per_gaussian
    MW = math.isqrt(M)
    if MW * MW != M:
        raise ValueError("max_tiles_per_gaussian must be a perfect square")
    B = colors.shape[0]
    txn, tyn = _cdiv(width, ts), _cdiv(height, ts)
    n_tiles = txn * tyn

    with record_function("render::binning"):
        ctx = _bin_gaussians(projs, colors, opacities, height, width, ts, MW, MW)
    if caps is not None:
        caps = caps.to(torch.int32).contiguous()
    with record_function("render::blend"):
        color_t, T_t, _, _ = blend_tiles(ctx.packed, ctx.sorted_vals, ctx.offsets,
                                         txn, ts, n_tiles, caps)
    overflow = ctx.m_dropped.to(torch.int64)
    if caps is not None:
        full = ctx.full_counts.to(torch.int64)
        overflow = overflow + (full - torch.minimum(full, caps.to(torch.int64).clamp_min(0))).sum()

    with record_function("render::untile"):
        img = torch.stack([_untile(c, txn, tyn, ts, height, width)
                           for c in color_t.reshape(B, n_tiles, 3, ts * ts)])
        T_img = torch.stack([_untile(t, txn, tyn, ts, height, width)[0]
                             for t in T_t.reshape(B, n_tiles, 1, ts * ts)])
        img = img + T_img[:, None] * bg[None, :, None, None]
    return img, overflow
