"""The plain reference's renderer: the pinhole camera, the EWA projection of
isotropic gaussians, the binning of (gaussian, tile) pairs in depth order,
and the per-pixel alpha blend with its gating rules, walked in chunks of
rows so that a tile stops once every pixel of it has terminated.

Semantics (the 3DGS rasterizer's, as the program's blend keeps them): a
row is skipped where power > 0 or alpha < 1/255, alpha is clamped at 0.99
with its gradient passed straight through the clamp, and a pixel stops
before the row that would take its transmittance below 1e-4. A gaussian
covers at most M = m x m tiles, recentred on its mean's tile; within a
tile the rows are ordered by a depth key quantised to as many bits as fit
beside the tile id for the batch's views, ties by gaussian index (the
order the program and the JAX package share). Every function is plain
torch, differentiable where the training check needs it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
ZNEAR, ZFAR = 0.01, 100.0


def camera(R: np.ndarray, t: np.ndarray, K: np.ndarray, H: int, W: int) -> dict:
    """A camera's arrays in the 3DGS convention (matrices transposed,
    row vectors): world_view_transform, full_proj_transform, tan_fovx,
    tan_fovy, float32. `R` is the rotation as datasets store it
    (transposed), `t` the translation."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    w2v = np.float32(np.linalg.inv(np.linalg.inv(Rt)))
    fx, fy = K[0, 0], K[1, 1]
    nfx, nfy = ZNEAR / fx, ZNEAR / fy
    left, right = -(W - K[0, 2]) * nfx, K[0, 2] * nfx
    bottom, top = (K[1, 2] - H) * nfy, K[1, 2] * nfy
    P = np.zeros((4, 4))
    P[0, 0] = 2.0 * ZNEAR / (right - left)
    P[1, 1] = 2.0 * ZNEAR / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    P = np.float32(P)
    fovx, fovy = 2 * math.atan(W / (2 * fx)), 2 * math.atan(H / (2 * fy))
    return {"world_view_transform": w2v.T.astype(np.float32),
            "full_proj_transform": (w2v.T @ P.T).astype(np.float32),
            "tan_fovx": np.float32(math.tan(fovx * 0.5)),
            "tan_fovy": np.float32(math.tan(fovy * 0.5))}


class Projected(NamedTuple):
    means2d: torch.Tensor   # (B, N, 2)
    depths: torch.Tensor    # (B, N)
    conics: torch.Tensor    # (B, N, 3)
    radii: torch.Tensor     # (B, N), 0 where culled


def project(means: torch.Tensor, scales: torch.Tensor, wvt: torch.Tensor, fpt: torch.Tensor,
            tanx: torch.Tensor, tany: torch.Tensor, H: int, W: int) -> Projected:
    """EWA projection of B views of N isotropic gaussians (identity
    rotations): means (B, N, 3), scales (B, N, 3)."""
    p4 = torch.cat([means, torch.ones_like(means[..., :1])], -1)
    pv = p4 @ wvt
    pc = p4 @ fpt
    pw = 1.0 / (pc[..., 3] + 1e-7)
    pp = pc[..., :3] * pw[..., None]
    tx, ty, tz = pv[..., 0], pv[..., 1], pv[..., 2]
    tzs = torch.where(tz.abs() < 1e-8, torch.full_like(tz, 1e-8), tz)
    limx, limy = (1.3 * tanx)[:, None], (1.3 * tany)[:, None]
    tx = torch.minimum(torch.maximum(tx / tzs, -limx), limx) * tzs
    ty = torch.minimum(torch.maximum(ty / tzs, -limy), limy) * tzs
    fx, fy = (W / (2.0 * tanx))[:, None], (H / (2.0 * tany))[:, None]
    j00, j02 = fx / tzs, -(fx * tx) / (tzs * tzs)
    j11, j12 = fy / tzs, -(fy * ty) / (tzs * tzs)
    Wr = wvt[:, :3, :3].transpose(1, 2)[:, None]
    m0 = j00[..., None] * Wr[..., 0, :] + j02[..., None] * Wr[..., 2, :]
    m1 = j11[..., None] * Wr[..., 1, :] + j12[..., None] * Wr[..., 2, :]
    b0, b1 = m0 * scales, m1 * scales
    cxx = (b0 * b0).sum(-1) + 0.3
    cyy = (b1 * b1).sum(-1) + 0.3
    cxy = (b0 * b1).sum(-1)
    det = cxx * cyy - cxy * cxy
    ok = det > 0.0
    dets = torch.where(ok, det, torch.ones_like(det))
    inv = 1.0 / dets
    conics = torch.stack([cyy * inv, -cxy * inv, cxx * inv], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - dets, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    mx = ((pp[..., 0] + 1.0) * W - 1.0) * 0.5
    my = ((pp[..., 1] + 1.0) * H - 1.0) * 0.5
    valid = (tz > 0.2) & ok
    return Projected(torch.stack([mx, my], -1), tz.detach(), conics,
                     torch.where(valid, radius, torch.zeros_like(radius)).detach())


def depth_bits(n_tiles_total: int) -> int:
    bits = 28
    while n_tiles_total << bits >= 2 ** 31 and bits > 8:
        bits -= 1
    return bits


class Bins(NamedTuple):
    """The (gaussian, tile) pairs of B views: tile g = b T + t owns the
    gaussian ids gids[starts[g]:starts[g] + counts[g]], nearest first."""
    gids: torch.Tensor     # (L,) int64 flat ids b N + n
    starts: torch.Tensor   # (B T,) int64
    counts: torch.Tensor   # (B T,) int64
    txn: int
    tyn: int


def bin_pairs(pr: Projected, opacity: torch.Tensor, H: int, W: int, ts: int, M: int) -> Bins:
    """Bin B views (opacity (B, N)): each gaussian with radius > 0 and
    opacity >= 1/255 covers the tiles of its rect [floor((m - r) / ts),
    floor((m + r + ts - 1) / ts)) clamped to the grid, at most m x m of
    them, recentred on its mean's tile where the rect is wider."""
    B, N = pr.depths.shape
    m = math.isqrt(M)
    txn, tyn = -(-W // ts), -(-H // ts)
    T = txn * tyn
    dev = pr.depths.device
    mx, r = pr.means2d.detach(), pr.radii
    v = (r > 0) & (opacity >= ALPHA_MIN)

    def rect(c, n):
        lo = torch.clamp(torch.floor((c - r) / ts), 0, n)
        hi = torch.clamp(torch.floor((c + r + ts - 1) / ts), 0, n)
        mid = torch.clamp(torch.floor(c / ts), lo, torch.maximum(hi - 1, lo))
        span = hi - lo
        lo = torch.where(span > m, torch.clamp(mid - m // 2, lo, hi - m), lo)
        return lo.long(), torch.clamp_max(span, m).long()

    x0, sx = rect(mx[..., 0], txn)
    y0, sy = rect(mx[..., 1], tyn)
    bits = depth_bits(B * T)
    dkey = (torch.clamp_min(pr.depths, 1e-6).contiguous().view(torch.int32) >> (32 - bits)).long()
    keys, ids = [], []
    flat = torch.arange(B * N, device=dev).reshape(B, N)
    for s in range(M):
        ox, oy = s % m, s // m
        ok = v & (ox < sx) & (oy < sy)
        tile = torch.arange(B, device=dev)[:, None] * T + (y0 + oy) * txn + (x0 + ox)
        keys.append(((tile << bits) | dkey)[ok])
        ids.append(flat[ok])
    keys, ids = torch.cat(keys), torch.cat(ids)
    order = torch.argsort(keys * (B * N) + ids)
    keys, ids = keys[order], ids[order]
    counts = torch.bincount(keys >> bits, minlength=B * T)
    starts = torch.cumsum(counts, 0) - counts
    return Bins(ids, starts, counts, txn, tyn)


class Walk(NamedTuple):
    color: torch.Tensor      # (G, P, 3) premultiplied, G = the tiles given
    T: torch.Tensor          # (G, P) final transmittance
    n_contrib: torch.Tensor  # (G, P) int64: 1 + the last contributing row
    contributing: torch.Tensor  # () int64: (gaussian, pixel) pairs that contribute
    used: torch.Tensor       # (G, K) bool: rows that contribute to some pixel


def walk(px, py, mean, conic, col, opac, n_rows, chunk: int = 64) -> Walk:
    """Blend G tiles' rows (mean (G, K, 2), conic (G, K, 3), col (G, K, 3),
    opac (G, K); rows at or past n_rows (G,) are absent) into their pixels
    (px, py (G, P)), nearest row first, `chunk` rows at a time; stops once
    every pixel has terminated. Differentiable in mean, conic and col."""
    G, K = opac.shape
    P = px.shape[1]
    dev = px.device
    color = torch.zeros((G, P, 3), device=dev)
    Tc = torch.ones((G, P), device=dev)
    done = torch.zeros((G, P), dtype=torch.bool, device=dev)
    ncon = torch.zeros((G, P), dtype=torch.int64, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    used = torch.zeros((G, K), dtype=torch.bool, device=dev)
    for k0 in range(0, K, chunk):
        k1 = min(K, k0 + chunk)
        sl = slice(k0, k1)
        dx = px[:, None, :] - mean[:, sl, 0:1]
        dy = py[:, None, :] - mean[:, sl, 1:2]
        a, b, c = conic[:, sl, 0:1], conic[:, sl, 1:2], conic[:, sl, 2:3]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        raw = opac[:, sl, None] * torch.exp(power)
        alpha = raw + (torch.clamp_max(raw, ALPHA_MAX) - raw).detach()
        idx = torch.arange(k0, k1, device=dev)
        present = (idx[None, :] < n_rows[:, None])[..., None]
        gate = present & (power <= 0.0) & (alpha >= ALPHA_MIN)
        alpha = torch.where(gate, alpha, torch.zeros_like(alpha))
        om = 1.0 - alpha
        incl = torch.cumprod(om, 1)
        before = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1) * Tc[:, None]
        trig = gate & (before * om < T_EPS) & ~done[:, None]
        dn = (torch.cumsum(trig.to(torch.int32), 1) > 0) | done[:, None]
        contrib = gate & ~dn
        w = torch.where(contrib, alpha * before, torch.zeros_like(alpha))
        color = color + torch.einsum("gkp,gkc->gpc", w, col[:, sl])
        Tc = Tc * torch.where(contrib, om, torch.ones_like(om)).prod(1)
        last = torch.where(contrib, (idx + 1)[None, :, None], torch.zeros_like(idx)[None, :, None])
        ncon = torch.maximum(ncon, last.amax(1))
        total = total + contrib.sum()
        used[:, sl] = contrib.any(2)
        done = dn[:, -1]
        if bool(done.all()):
            break
    return Walk(color, Tc, ncon, total, used)


def tile_pixels(tiles: torch.Tensor, txn: int, T: int, ts: int):
    """Pixel centres (px, py), each (G, ts*ts), of tiles g = b T + t."""
    f = torch.arange(ts * ts, device=tiles.device)
    loc = tiles % T
    px = ((loc % txn) * ts)[:, None] + (f % ts)[None]
    py = ((loc // txn) * ts)[:, None] + (f // ts)[None]
    return px.float(), py.float()


def render(pr: Projected, colors: torch.Tensor, opacity: torch.Tensor, bg: torch.Tensor,
           H: int, W: int, ts: int, M: int, caps: Optional[torch.Tensor] = None,
           chunk: int = 64, chunk_elems: int = 1 << 24, rows_elems: int = 1 << 24):
    """Render B views -> (images (B, 3, H, W), {'n_contrib': (B T, ts*ts),
    'contributing': (gaussian, pixel) pairs that contribute, 'gaussians':
    gaussians that contribute to some pixel, 'pixels'}). `caps` (B T,)
    bounds each tile's rows. Tiles are walked deepest first, in groups whose
    chunk of rows (tiles x chunk x pixels) stays under `chunk_elems` and
    whose gathered rows (tiles x depth) under `rows_elems`."""
    B, N = opacity.shape
    bins = bin_pairs(pr, opacity, H, W, ts, M)
    T = bins.txn * bins.tyn
    PX = ts * ts
    dev = opacity.device
    n = bins.counts if caps is None else torch.minimum(bins.counts, caps.long().clamp_min(0))
    mean = pr.means2d.reshape(B * N, 2)
    conic = pr.conics.reshape(B * N, 3)
    col = colors.reshape(B * N, 3)
    op = opacity.reshape(B * N)
    color_t = torch.zeros((B * T, PX, 3), device=dev)
    T_t = torch.ones((B * T, PX), device=dev)
    ncon = torch.zeros((B * T, PX), dtype=torch.int64, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    used = torch.zeros(B * N, dtype=torch.bool, device=dev)
    n_host = n.cpu()
    order = torch.argsort(n_host, descending=True, stable=True)
    order = order[n_host[order] > 0]
    i = 0
    while i < order.shape[0]:
        K = int(n_host[order[i]])
        S = max(1, min(chunk_elems // (chunk * PX), rows_elems // K))
        tiles = order[i:i + S].to(dev)
        i += S
        ks = torch.arange(K, device=dev)
        pos = (bins.starts[tiles][:, None] + ks[None]).clamp_max(bins.gids.shape[0] - 1)
        g = bins.gids[pos]
        px, py = tile_pixels(tiles, bins.txn, T, ts)
        w = walk(px, py, mean[g], conic[g], col[g], op[g], n[tiles], chunk)
        color_t = color_t.index_put((tiles,), w.color)
        T_t = T_t.index_put((tiles,), w.T)
        ncon[tiles] = w.n_contrib
        total = total + w.contributing
        used[g[w.used]] = True
    img = color_t + T_t[..., None] * bg
    img = img.reshape(B, bins.tyn, bins.txn, ts, ts, 3).permute(0, 5, 1, 3, 2, 4)
    img = img.reshape(B, 3, bins.tyn * ts, bins.txn * ts)[:, :, :H, :W]
    return img, {"n_contrib": ncon, "contributing": int(total), "gaussians": int(used.sum()),
                 "pixels": B * H * W}


def need_caps(ncon: torch.Tensor, margin: float = 1.5, cap: int = 4096) -> torch.Tensor:
    """The need table's caps of B views' tiles from an uncapped walk's
    n_contrib: the deepest pixel's, times the margin, rounded up, at most
    `cap`."""
    needed = ncon.amax(1).to(torch.float32)
    return torch.clamp_max(torch.ceil(needed * margin), cap).to(torch.int64)
