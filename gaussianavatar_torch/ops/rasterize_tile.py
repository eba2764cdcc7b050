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
  3. its gradient (`blend_tiles_bwd`): the hand-written CUDA kernel H-bwd
     (`csrc/blend_bwd.cu`) walks each tile back to front and writes one
     gradient row per (tile, gaussian) pair; `BlendTiles` pairs it with H-fwd
     in one autograd Function and scatter-adds the pair rows into the packed
     table. Its plain version is `blend_tiles_bwd_plain`.

The JAX package blends at most K rows per tile (capacity tiers) because a
TPU kernel needs static shapes; the port has no tiers. It takes the one
capacity that shapes training, a per-tile row cap (`caps`), which the
training loop's need table sizes from `probe_tile_depths`
(engine/need_table.py). The footprint cap M stays: a gaussian covers at
most MW x MH tiles, and every clipped (gaussian, tile) pair is counted in
the reported overflow.

Sorting is always stable: ties of (tile, depth key) blend in gaussian-index
order, through one sort of the 64-bit key (key << 32) | row.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from gaussianavatar_torch.ops.projection import ProjectedGaussians
from gaussianavatar_torch.ops.rasterize_ref import (
    ALPHA_MAX, ALPHA_MIN, T_EPS, blend_pixels, gate_terms,
)
from gaussianavatar_torch.utils.spans import span

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
    m_dropped, raw_pairs). The rect is CUDA getRect's ([min, max) clamped
    to the grid); footprints wider than MW x MH tiles are recentered on the
    mean's tile and clipped, and every clipped valid pair is counted in
    `m_dropped`; `raw_pairs` sums the valid gaussians' uncapped areas."""
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
    zero = torch.zeros_like(raw_area)
    m_dropped = torch.where(v, raw_area - spanx * spany, zero).sum()
    raw_pairs = torch.where(v, raw_area, zero).sum()
    return x0, y0, spanx, spany, m_dropped, raw_pairs


def footprint_drop(projs: ProjectedGaussians, opacities: torch.Tensor, height: int, width: int,
                   ts: int, M: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dropped pairs, total pairs) that a footprint cap of M tiles per
    gaussian would cut on this batch (B, N): the training loop's input for
    the adaptive footprint (engine/need_table.py), rect arithmetic on the
    projections with no binning, as the JAX package's `footprint_drop`."""
    MW = math.isqrt(M)
    B, N = projs.depths.shape
    txn, tyn = _cdiv(width, ts), _cdiv(height, ts)
    v = (projs.radii > 0) & (opacities.reshape(B, N) >= ALPHA_MIN)
    *_, m_dropped, raw_pairs = _footprint_rects(projs.means2d, projs.radii, v, ts, txn, tyn,
                                                MW, MW)
    return m_dropped, raw_pairs


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
    key_views: int = 0,
) -> BinContext:
    """Bin a whole batch with ONE sort. Key: ((b*T + tile) << depth_bits) |
    depth_quant, the top depth_bits of the positive float pattern of the
    depth (monotone); the row index breaks ties. depth_bits is budgeted for
    max(B, key_views) views: a data-parallel rank that renders its share of
    a batch of key_views views quantizes depths as the whole batch would,
    so its frames blend in the order the unsharded batch blends them."""
    B, N = projs.depths.shape
    txn, tyn = _cdiv(width, ts), _cdiv(height, ts)
    T = txn * tyn
    M = MW * MH
    dev = projs.depths.device
    depth_bits = depth_key_bits(max(B, key_views) * T)

    ops = opacities.reshape(B, N)
    # opacity < 1/255 can never pass the alpha floor: drop at binning (this is
    # how padding gaussians with opacity 0 become free)
    v = (projs.radii > 0) & (ops.detach() >= ALPHA_MIN)
    mx = projs.means2d
    # rects and keys are integers: no gradient flows through them
    x0, y0, spanx, spany, m_dropped, _ = _footprint_rects(
        mx.detach(), projs.radii.detach(), v, ts, txn, tyn, MW, MH)

    depth_key = torch.clamp_min(projs.depths.detach(), 1e-6).contiguous().view(torch.int32) \
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


def _deepest_first(lengths: torch.Tensor) -> torch.Tensor:
    """The kernels' block order: block ids (int32) by walk length, longest
    first (longest-processing-time first), ties in id order. On the device
    of `lengths`, with no host read."""
    return torch.argsort(lengths, descending=True, stable=True).to(torch.int32)


def _block_split(ts: int) -> Tuple[int, int]:
    """The kernels' work split -> (nq, side): a tile of ts x ts pixels is
    walked by nq x nq blocks, each over a sub-tile of side x side pixels:
    the four 16 x 16 quadrants of a 32 px tile, or one block for a tile of
    at most 16 px."""
    nq = 2 if ts > 16 else 1
    return nq, _cdiv(ts, nq)


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


def _check(fn, name, t, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_table(fn, packed, sorted_vals, offsets, caps, ts):
    """Shared argument checks of the two kernels' wrappers -> (G, PX)."""
    G = offsets.shape[0] - 1
    PX = ts * ts
    if not 0 < PX <= 1024:
        raise ValueError(f"{fn}: tile size {ts} needs 1 to 1024 pixels per tile")
    _check(fn, "packed", packed, torch.float32)
    if packed.dim() != 2 or packed.shape[1] != 16:
        raise ValueError(f"{fn}: packed must be (rows, 16), got {tuple(packed.shape)}")
    if packed.data_ptr() % 16:
        # the kernels copy its rows in 16-byte cp.async chunks
        raise ValueError(f"{fn}: packed must be 16-byte aligned")
    _check(fn, "sorted_vals", sorted_vals, torch.int32)
    _check(fn, "offsets", offsets, torch.int32, (G + 1,))
    if caps is not None:
        _check(fn, "caps", caps, torch.int32, (G,))
    return G, PX


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
    `csrc/blend_fwd.cu` on first use) on the current stream: one block per
    `_block_split` sub-tile, the deepest tiles first; CPU tensors, and only
    they, take `blend_tiles_plain`. Outputs as `blend_tiles_plain`. Each
    launch adds one to `cuda_build.LAUNCHES["blend_fwd"]`."""
    if packed.device.type == "cpu":
        return blend_tiles_plain(packed, sorted_vals, offsets, txn, ts, n_tiles, caps)
    from gaussianavatar_torch.utils.cuda_build import LAUNCHES, load_library

    lib = load_library("blend_fwd")
    G, PX = _check_table("blend_tiles", packed, sorted_vals, offsets, caps, ts)
    dev = packed.device
    nq, side = _block_split(ts)
    counts = _capped_counts(offsets, caps).to(torch.int32)
    # a tile's blocks walk its rows side by side: each is as deep as the tile
    order = _deepest_first(counts[:, None].expand(G, nq * nq).reshape(-1))
    color = torch.empty((G, 3, PX), dtype=torch.float32, device=dev)
    T_out = torch.empty((G, PX), dtype=torch.float32, device=dev)
    ncon = torch.empty((G, PX), dtype=torch.int32, device=dev)
    done = torch.empty((G, PX), dtype=torch.float32, device=dev)
    fn = lib.ga_blend_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(packed.data_ptr(), sorted_vals.data_ptr(), offsets.data_ptr(),
            counts.data_ptr(), order.data_ptr(), order.shape[0], nq, side, n_tiles, txn, ts,
            color.data_ptr(), T_out.data_ptr(), ncon.data_ptr(), done.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["blend_fwd"] += 1
    return color, T_out, ncon, done


# --------------------------------------------------------------------------
# The blend's gradient: CUDA kernel H-bwd and its plain PyTorch version
# --------------------------------------------------------------------------

# per-pair gradient channels, in the order of the JAX kernels' slabs
GRAD_CHANNELS = ("mx", "my", "ca", "cb", "cc", "r", "g", "b", "op")


def _walk_ends(offsets, caps, n_contrib):
    """Rows of each tile that carry gradient: min(count, the deepest pixel's
    n_contrib). Pairs past it get zero."""
    return torch.minimum(_capped_counts(offsets, caps),
                         n_contrib.amax(dim=1).to(torch.int64))


def _pixel_blocks(ts: int, device=None) -> torch.Tensor:
    """(ts*ts,) int64: the block of its tile (0 .. nq*nq - 1, row-major, as
    `_block_split` cuts it) that walks each pixel."""
    nq, side = _block_split(ts)
    f = torch.arange(ts * ts, device=device)
    return (f // ts // side) * nq + f % ts // side


def _block_walk_ends(offsets, caps, n_contrib, ts):
    """(G, nq*nq) int64: the rows each H-bwd block walks, min(count, the
    deepest n_contrib among its pixels). Their max over a tile's blocks is
    `_walk_ends`; rows of a block past its end carry none of its gradient."""
    G, PX = n_contrib.shape
    nq, _ = _block_split(ts)
    blocks = _pixel_blocks(ts, n_contrib.device).expand(G, PX)
    deepest = torch.zeros((G, nq * nq), dtype=n_contrib.dtype, device=n_contrib.device)
    deepest.scatter_reduce_(1, blocks, n_contrib, "amax")
    return torch.minimum(_capped_counts(offsets, caps)[:, None], deepest.to(torch.int64))


def blend_tiles_bwd_plain(
    packed: torch.Tensor,        # (B*N, 16) f32, as H-fwd
    sorted_vals: torch.Tensor,   # (L,) int32
    offsets: torch.Tensor,       # (G+1,) int32
    txn: int,
    ts: int,
    n_tiles: int,
    finalT: torch.Tensor,        # (G, ts*ts) f32, H-fwd's T
    n_contrib: torch.Tensor,     # (G, ts*ts) int32, H-fwd's n_contrib
    grad_color: torch.Tensor,    # (G, 3, ts*ts) f32
    grad_T: torch.Tensor,        # (G, ts*ts) f32
    caps: Optional[torch.Tensor] = None,
    max_elems: int = 1 << 32,
) -> torch.Tensor:
    """Plain PyTorch version of H-bwd: per-pair gradients (L, 9) f32, row i
    for the pair at sorted position i, channels `GRAD_CHANNELS`.

    The sequential reverse walk of the JAX `_bwd_kernel`, every tile of a
    group at once: T is rebuilt by division from `finalT`, the suffix colours
    are carried, and the 0.99 clamp passes its gradient straight through
    (dpow = gval * opacity * dalpha). Rows past `_walk_ends` stay zero.
    Groups come from `_tile_groups`; `max_elems` bounds (tiles x rows x
    pixels) of a group, whose rows tensor is 16/(ts*ts) of that."""
    L = sorted_vals.shape[0]
    dev = packed.device
    out = torch.zeros((L, 9), dtype=torch.float32, device=dev)
    ends = _walk_ends(offsets, caps, n_contrib)
    for tiles, px, py, rows, in_range in _tile_groups(packed, sorted_vals, offsets, ends,
                                                      txn, ts, n_tiles, max_elems):
        S, K = rows.shape[:2]
        fT, nc, gT = finalT[tiles], n_contrib[tiles], grad_T[tiles]
        gr, gg, gb = grad_color[tiles].unbind(1)
        T = fT
        ar = ag = ab = torch.zeros_like(fT)
        sums = torch.zeros((S, K, 9), dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(K - 1, -1, -1):
            mx, my, ca, cb, cc, r, g, b, op, valid = (rows[:, k, i:i + 1] for i in range(10))
            dx = px - mx
            dy = py - my
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            gval = torch.exp(power)
            alpha = torch.clamp_max(op * gval, ALPHA_MAX)
            m = (in_range[:, k:k + 1] & (valid > 0) & (power <= 0.0) & (alpha >= ALPHA_MIN)
                 & (k < nc))
            one_m = 1.0 - alpha
            Tn = torch.where(m, T / one_m, T)
            wT = torch.where(m, alpha * Tn, zero)
            dalpha = ((r - ar) * gr + (g - ag) * gg + (b - ab) * gb) * Tn + (-fT / one_m) * gT
            dalpha = torch.where(m, dalpha, zero)
            ar = torch.where(m, alpha * r + one_m * ar, ar)
            ag = torch.where(m, alpha * g + one_m * ag, ag)
            ab = torch.where(m, alpha * b + one_m * ab, ab)
            dpow = torch.where(m, gval * op * dalpha, zero)
            sums[:, k] = torch.stack([
                dpow * (ca * dx + cb * dy),
                dpow * (cb * dx + cc * dy),
                -0.5 * dx * dx * dpow,
                -dx * dy * dpow,
                -0.5 * dy * dy * dpow,
                wT * gr,
                wT * gg,
                wT * gb,
                torch.where(m, gval * dalpha, zero),
            ], dim=-1).sum(dim=1)
            T = Tn
        pos = offsets[tiles].to(torch.int64)[:, None] + torch.arange(K, device=dev)[None]
        out[pos[in_range]] = sums[in_range]
    return out


def blend_bwd_walk_counts(
    packed: torch.Tensor,
    sorted_vals: torch.Tensor,
    offsets: torch.Tensor,
    txn: int,
    ts: int,
    n_tiles: int,
    n_contrib: torch.Tensor,
    caps: Optional[torch.Tensor] = None,
    max_elems: int = 1 << 24,
) -> dict:
    """The (row, pixel) pairs H-bwd walks on these inputs, by how each ends:
    `past_last` (the row lies at or past the pixel's n_contrib), `cut_power`
    (power > 0), `cut_alpha` (alpha < 1/255) and `contributing`. Every pixel
    of a tile walks the tile's rows below `_walk_ends`. Arguments as
    `blend_tiles_bwd_plain`; used to bound the kernel's work, nowhere on the
    training path."""
    ends = _walk_ends(offsets, caps, n_contrib)
    tot = dict.fromkeys(("past_last", "cut_power", "cut_alpha", "contributing"), 0)
    for tiles, px, py, rows, in_range in _tile_groups(packed, sorted_vals, offsets, ends,
                                                      txn, ts, n_tiles, max_elems):
        opac = torch.where(rows[..., 9] > 0, rows[..., 8], torch.zeros_like(rows[..., 8]))
        power, alpha = gate_terms(px, py, rows[..., 0:2], rows[..., 2:5], opac)
        k = torch.arange(rows.shape[1], device=rows.device)[None, :, None]
        walked = in_range[..., None].expand_as(power)
        past = walked & (k >= n_contrib[tiles][:, None, :])
        cut_power = walked & ~past & (power > 0.0)
        cut_alpha = walked & ~past & ~cut_power & (alpha < ALPHA_MIN)
        tot["past_last"] += int(past.sum())
        tot["cut_power"] += int(cut_power.sum())
        tot["cut_alpha"] += int(cut_alpha.sum())
        tot["contributing"] += int((walked & ~past & ~cut_power & ~cut_alpha).sum())
    return tot


def blend_tiles_bwd(
    packed: torch.Tensor,
    sorted_vals: torch.Tensor,
    offsets: torch.Tensor,
    txn: int,
    ts: int,
    n_tiles: int,
    finalT: torch.Tensor,
    n_contrib: torch.Tensor,
    grad_color: torch.Tensor,
    grad_T: torch.Tensor,
    caps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The blend's gradient per (tile, gaussian) pair. CUDA tensors launch
    the H-bwd kernel (built from `csrc/blend_bwd.cu` on first use) on the
    current stream: one block per `_block_split` sub-tile, deepest walk
    first (`_block_walk_ends`, `_deepest_first`); the blocks of a tile add
    their partial rows in block order in the kernel. CPU tensors, and only
    they, take `blend_tiles_bwd_plain`. Output as `blend_tiles_bwd_plain`,
    one row per entry of `sorted_vals`, which must hold at least offsets[-1]
    entries (the binned prefix is enough). Each launch adds one to
    `cuda_build.LAUNCHES["blend_bwd"]`."""
    if packed.device.type == "cpu":
        return blend_tiles_bwd_plain(packed, sorted_vals, offsets, txn, ts, n_tiles,
                                     finalT, n_contrib, grad_color, grad_T, caps)
    from gaussianavatar_torch.utils.cuda_build import LAUNCHES, load_library

    lib = load_library("blend_bwd")
    fn_name = "blend_tiles_bwd"
    G, PX = _check_table(fn_name, packed, sorted_vals, offsets, caps, ts)
    _check(fn_name, "finalT", finalT, torch.float32, (G, PX))
    _check(fn_name, "n_contrib", n_contrib, torch.int32, (G, PX))
    _check(fn_name, "grad_color", grad_color, torch.float32, (G, 3, PX))
    _check(fn_name, "grad_T", grad_T, torch.float32, (G, PX))
    dev = packed.device
    nq, side = _block_split(ts)
    ends = _block_walk_ends(offsets, caps, n_contrib, ts).reshape(-1).to(torch.int32)
    order = _deepest_first(ends)
    L = sorted_vals.shape[0]
    grads = torch.zeros((L, 9), dtype=torch.float32, device=dev)
    # a tile of several blocks: their partial rows, and a ticket per tile so
    # that the last block to finish adds them
    split = nq > 1
    slab = torch.empty((nq * nq, L, 9), dtype=torch.float32, device=dev) if split else None
    tickets = torch.zeros((G,), dtype=torch.int32, device=dev) if split else None
    fn = lib.ga_blend_bwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 7
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(packed.data_ptr(), sorted_vals.data_ptr(), offsets.data_ptr(),
            order.data_ptr(), ends.data_ptr(), ends.shape[0], nq, side, n_tiles, txn, ts,
            finalT.data_ptr(), n_contrib.data_ptr(), grad_color.data_ptr(), grad_T.data_ptr(),
            grads.data_ptr(), slab.data_ptr() if split else None,
            tickets.data_ptr() if split else None, L, stream)
    if rc != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["blend_bwd"] += 1
    return grads


def scatter_pair_grads(pair_grads: torch.Tensor, sorted_vals: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """Per-pair gradients (L, 9) -> the packed table's gradient (n_rows, 16):
    each pair's row added into its gaussian's (`index_add_`, the counterpart
    of the JAX gather's VJP; on the card its atomics add in no fixed order)."""
    d = torch.zeros((n_rows, 9), dtype=pair_grads.dtype, device=pair_grads.device)
    d.index_add_(0, sorted_vals.to(torch.int64), pair_grads)
    return torch.nn.functional.pad(d, (0, 7))


class BlendTiles(torch.autograd.Function):
    """The differentiable tile blend: H-fwd forward, H-bwd backward.
    apply(packed, sorted_vals, offsets, caps, txn, ts, n_tiles) ->
    (color, T, n_contrib, done) as `blend_tiles`; the gradient reaches
    `packed` only (n_contrib and done carry none)."""

    @staticmethod
    def forward(ctx, packed, sorted_vals, offsets, caps, txn, ts, n_tiles):
        color, T, ncon, done = blend_tiles(packed, sorted_vals, offsets, txn, ts, n_tiles, caps)
        ctx.mark_non_differentiable(ncon, done)
        ctx.save_for_backward(packed, sorted_vals, offsets, caps, T, ncon)
        ctx.geometry = (txn, ts, n_tiles)
        return color, T, ncon, done

    @staticmethod
    def backward(ctx, g_color, g_T, _g_ncon, _g_done):
        packed, sorted_vals, offsets, caps, T, ncon = ctx.saved_tensors
        # the whole slot table, a static length: no host read, so a CUDA
        # graph can record the step. Unbinned slots sort last; H-bwd walks
        # only the tiles' ranges and leaves their rows 0, which the scatter
        # adds in as +0
        with span("render::blend_bwd", packed.device):
            pair = blend_tiles_bwd(packed, sorted_vals, offsets, *ctx.geometry, T, ncon,
                                   g_color.contiguous(), g_T.contiguous(), caps)
        with span("render::scatter_bwd", packed.device):
            d_packed = scatter_pair_grads(pair, sorted_vals, packed.shape[0])
        return d_packed, None, None, None, None, None, None


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
    every binned pair was blendable). Differentiable in the projected means,
    conics, colours and opacities through `BlendTiles`; the cotangent of T
    that reaches H-bwd is sum_c bg_c * dL/dimg_c."""
    ts = config.tile_size
    M = config.max_tiles_per_gaussian
    MW = math.isqrt(M)
    if MW * MW != M:
        raise ValueError("max_tiles_per_gaussian must be a perfect square")
    B = colors.shape[0]
    txn, tyn = _cdiv(width, ts), _cdiv(height, ts)
    n_tiles = txn * tyn

    with span("render::binning", colors.device):
        ctx = _bin_gaussians(projs, colors, opacities, height, width, ts, MW, MW,
                             key_views=config.key_views)
    if caps is not None:
        caps = caps.to(torch.int32).contiguous()
    with span("render::blend", colors.device):
        color_t, T_t, _, _ = BlendTiles.apply(ctx.packed, ctx.sorted_vals, ctx.offsets, caps,
                                              txn, ts, n_tiles)
    overflow = ctx.m_dropped.to(torch.int64)
    if caps is not None:
        full = ctx.full_counts.to(torch.int64)
        overflow = overflow + (full - torch.minimum(full, caps.to(torch.int64).clamp_min(0))).sum()

    with span("render::untile", colors.device):
        img = torch.stack([_untile(c, txn, tyn, ts, height, width)
                           for c in color_t.reshape(B, n_tiles, 3, ts * ts)])
        T_img = torch.stack([_untile(t, txn, tyn, ts, height, width)[0]
                             for t in T_t.reshape(B, n_tiles, 1, ts * ts)])
        img = img + T_img[:, None] * bg[None, :, None, None]
    return img, overflow


@torch.no_grad()
def probe_tile_depths(
    projs: ProjectedGaussians,   # batched (B, N, ...) fields
    colors: torch.Tensor,        # (B, N, 3)
    opacities: torch.Tensor,     # (B, N)
    height: int,
    width: int,
    config,
    probe_capacity: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The saturation probe (the JAX package's `probe_tile_depths`): one
    blend with every tile capped at `probe_capacity` rows -> per tile
    (binned count, NEEDED depth), both (B*T,) int32. The needed depth is the
    largest n_contrib over the tile's pixels: the rank at which the blend's
    early termination stopped taking gaussians, so a cap at or above it
    blends, forward and backward, what the uncapped blend does."""
    ts = config.tile_size
    MW = math.isqrt(config.max_tiles_per_gaussian)
    B = colors.shape[0]
    txn, tyn = _cdiv(width, ts), _cdiv(height, ts)
    n_tiles = txn * tyn
    ctx = _bin_gaussians(projs, colors, opacities.reshape(B, -1), height, width, ts, MW, MW)
    caps = torch.full((B * n_tiles,), probe_capacity, dtype=torch.int32,
                      device=ctx.offsets.device)
    _, _, ncon, _ = blend_tiles(ctx.packed, ctx.sorted_vals, ctx.offsets, txn, ts, n_tiles, caps)
    return ctx.full_counts, ncon.reshape(B * n_tiles, -1).amax(dim=1).to(torch.int32)
