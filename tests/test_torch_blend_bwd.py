"""Port parity, the blend's gradient: the plain version of H-bwd against each
of the four JAX backward kernels run in interpret mode (`_bwd_kernel`,
`_bwd_kernel_vec`, `_ragged_bwd_kernel`, `_ragged_bwd_kernel_vec`), isolated
from the forward: both sides get the port's own finalT and n_contrib, so
n_contrib cannot differ by a rank. Scenes: a dense one where most pixels
terminate early, and one of opacity 1 where the 0.99 clamp bites (its
gradient passes straight through); each with and without per-tile caps.

Tolerance: per channel, max |port - JAX| <= 1e-5 x the channel's largest
|gradient|. Both walk the same rows in the same order per pixel; only the
sums over a tile's 256 pixels run in another order (and the vectorized
kernels reassociate their suffix products), each an f32 rounding of ~1e-7
relative to the largest term.

Then `BlendTiles` end to end: the gradient of a weighted sum of the image
with respect to the projected means, conics, colours and opacities, through
the port's binning and scatter, against `jax.grad` through the JAX Pallas
tile path (interpret mode, one capacity deep enough for every tile); and the
whole rasterizer, projection included, with respect to the 3D means,
scales, rotations, colours and opacities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.ops import rasterize_ragged as jr
from gaussianavatar_tpu.ops import rasterize_tile as jt
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.ops.projection import ProjectedGaussians as JProj
from gaussianavatar_tpu.ops.projection import project_gaussians as j_project
from gaussianavatar_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gaussianavatar_tpu.ops.rasterize import rasterize_views as j_rasterize_views

from gaussianavatar_torch.ops import rasterize_tile as tt
from gaussianavatar_torch.ops.projection import ProjectedGaussians as TProj
from gaussianavatar_torch.ops.projection import project_gaussians as t_project
from gaussianavatar_torch.ops.rasterize import RasterizeConfig, rasterize_views

torch.set_num_threads(2)

B, H, W, TS = 2, 48, 64, 16
TXN = W // TS
N_TILES = TXN * (H // TS)
G, PX = B * N_TILES, TS * TS
CB = 16       # ragged chunk rows
REL_TOL = 1e-5


def make_projs(scene, n=300, seed=0):
    """B views of n screen-space gaussians with positive-definite conics."""
    rng = np.random.default_rng(seed)
    sig = rng.uniform(1.5, 5.0, (B, n))
    rho = rng.uniform(-0.4, 0.4, (B, n))
    cxx, cyy = sig**2, (sig * rng.uniform(0.6, 1.4, (B, n)))**2
    cxy = rho * np.sqrt(cxx * cyy)
    det = cxx * cyy - cxy**2
    lam = 0.5 * (cxx + cyy) + np.sqrt(np.maximum((0.5 * (cxx - cyy))**2 + cxy**2, 0.1))
    projs = TProj(
        means2d=torch.tensor(np.stack([rng.uniform(0, W, (B, n)), rng.uniform(0, H, (B, n))],
                                      -1), dtype=torch.float32),
        depths=torch.tensor(rng.uniform(0.5, 3.0, (B, n)), dtype=torch.float32),
        conics=torch.tensor(np.stack([cyy / det, -cxy / det, cxx / det], -1), dtype=torch.float32),
        radii=torch.tensor(np.ceil(3 * np.sqrt(lam)), dtype=torch.float32),
    )
    opac = (np.ones((B, n)) if scene == "opaque" else rng.uniform(0.5, 1.0, (B, n)))
    colors = rng.uniform(size=(B, n, 3))
    return projs, torch.tensor(colors, dtype=torch.float32), torch.tensor(opac, dtype=torch.float32)


@pytest.fixture(scope="module", params=["dense", "opaque"])
def case(request):
    """A scene binned (M=4), blended by the plain forward, a random
    cotangent, and random per-tile caps."""
    projs, colors, opac = make_projs(request.param)
    ctx = tt._bin_gaussians(projs, colors, opac, H, W, TS, 2, 2)
    rng = np.random.default_rng(1)
    counts = ctx.full_counts.numpy()
    caps = torch.tensor((rng.uniform(0, 1.2, counts.shape) * counts).astype(np.int32))
    grad_color = torch.tensor(rng.normal(size=(G, 3, PX)), dtype=torch.float32)
    grad_T = torch.tensor(rng.normal(size=(G, PX)), dtype=torch.float32)
    return request.param, ctx, caps, grad_color, grad_T


def _port(ctx, caps, grad_color, grad_T):
    args = (ctx.packed, ctx.sorted_vals, ctx.offsets, TXN, TS, N_TILES)
    _, finalT, ncon, done = tt.blend_tiles_plain(*args, caps=caps)
    pair = tt.blend_tiles_bwd_plain(*args, finalT, ncon, grad_color, grad_T, caps=caps)
    return finalT, ncon, done, pair.numpy()


def _jax_tile_bwd(ctx, counts, finalT, ncon, grad_color, grad_T, vec):
    """`_pallas_bwd` over every tile, capacity K >= every count -> (L, 9)."""
    K = max(8, -(-int(counts.max()) // 8) * 8)
    packed, vals, offs = ctx.packed.numpy(), ctx.sorted_vals.numpy(), ctx.offsets.numpy()
    ks = np.arange(K)
    in_range = ks[None] < counts[:, None]
    pos = np.minimum(offs[:-1, None] + ks[None], len(vals) - 1)
    params = packed[vals[pos]] * in_range[..., None]
    pxr, lanes = (1, PX) if vec else (PX // 128, 128)
    grads = jt._pallas_bwd(
        jnp.asarray(params, jnp.float32), jnp.asarray(counts, jnp.int32),
        jnp.arange(G, dtype=jnp.int32) % N_TILES,
        jnp.asarray(finalT.numpy().reshape(G, pxr, lanes)),
        jnp.asarray(ncon.numpy().reshape(G, pxr, lanes)),
        jnp.asarray(grad_color.numpy().reshape(G, 3, pxr, lanes)),
        jnp.asarray(grad_T.numpy().reshape(G, pxr, lanes)),
        TXN, TS, K, interpret=True, vec=vec)
    out = np.zeros((len(vals), 9), np.float32)
    out[pos[in_range]] = np.asarray(grads)[..., :9][in_range]
    return out


def _jax_ragged_bwd(ctx, counts, finalT, ncon, grad_color, grad_T, vec):
    """`_ragged_bwd` over the chunk stream of `counts` -> (L, 9)."""
    packed, vals, offs = ctx.packed.numpy(), ctx.sorted_vals.numpy(), ctx.offsets.numpy()
    C = int((-(-counts // CB)).sum())
    C = -(-C // 8) * 8
    ct, k0, last = (np.asarray(x) for x in jr._chunk_maps(jnp.asarray(counts, jnp.int32), CB, C))
    rows = k0[:, None] + np.arange(CB)[None]
    src = np.clip(offs[ct][:, None] + rows, 0, len(vals) - 1)
    table = packed[vals[src]]
    pxr, lanes = (1, PX) if vec else (PX // 128, 128)
    nc = ncon.numpy()
    grads = jr._ragged_bwd(
        jnp.asarray(table, jnp.float32), jnp.asarray(counts, jnp.int32), jnp.asarray(ct),
        jnp.asarray(k0), jnp.asarray(last), jnp.arange(G, dtype=jnp.int32) % N_TILES,
        jnp.asarray(nc.max(1).astype(np.int32)),
        jnp.asarray(finalT.numpy().reshape(G, pxr, lanes)), jnp.asarray(nc.reshape(G, pxr, lanes)),
        jnp.asarray(grad_color.numpy().reshape(G, 3, pxr, lanes)),
        jnp.asarray(grad_T.numpy().reshape(G, pxr, lanes)),
        CB=CB, ts=TS, txn=TXN, interpret=True, vec=vec)
    live = (k0[:, None] >= 0) & (rows < counts[ct][:, None])
    out = np.zeros((len(vals), 9), np.float32)
    out[src[live]] = np.asarray(grads)[..., :9][live]
    return out


def _assert_pairs_close(port, ref):
    assert np.abs(ref).max() > 0
    for c, name in enumerate(tt.GRAD_CHANNELS):
        scale = np.abs(ref[:, c]).max()
        err = np.abs(port[:, c] - ref[:, c]).max()
        assert err <= REL_TOL * scale, (name, err, scale)


KERNELS = {
    "bwd_kernel": (_jax_tile_bwd, False),
    "bwd_kernel_vec": (_jax_tile_bwd, True),
    "ragged_bwd_kernel": (_jax_ragged_bwd, False),
    "ragged_bwd_kernel_vec": (_jax_ragged_bwd, True),
}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_plain_bwd_matches_jax_kernel(case, kernel):
    scene, ctx, caps, grad_color, grad_T = case
    jax_bwd, vec = KERNELS[kernel]
    full = ctx.full_counts.numpy()
    for c in (None, caps):
        finalT, ncon, done, port = _port(ctx, c, grad_color, grad_T)
        counts = full if c is None else np.minimum(full, c.numpy())
        _assert_pairs_close(port, jax_bwd(ctx, counts, finalT, ncon, grad_color, grad_T, vec))
        if c is None:
            # the scene exercises what it is named for: early termination,
            # and contributing pairs whose alpha the 0.99 clamp cut
            assert done.float().mean() > 0.05
            if scene == "opaque":
                assert _clamped_pairs(ctx, ncon) > 0


def _clamped_pairs(ctx, ncon):
    """Contributing (row, pixel) pairs where opacity * exp(power) > 0.99."""
    n = 0
    for tiles, px, py, rows, in_range in tt._tile_groups(
            ctx.packed, ctx.sorted_vals, ctx.offsets, ctx.full_counts.long(), TXN, TS,
            N_TILES, 1 << 24):
        power, _ = tt.gate_terms(px, py, rows[..., 0:2], rows[..., 2:5], rows[..., 8])
        k = torch.arange(rows.shape[1])[None, :, None]
        live = in_range[..., None] & (k < ncon[tiles][:, None, :]) & (power <= 0)
        n += int((live & (rows[..., 8:9] * torch.exp(power) > 0.99)).sum())
    return n


def test_bwd_walk_counts_match_row_walk(case):
    """`blend_bwd_walk_counts` (the work H-bwd's bound is computed from)
    against the reverse walk written out row by row in numpy: every pixel of
    a tile walks the rows below the tile's deepest contributor, and each
    (row, pixel) pair is classified exactly."""
    _, ctx, caps, _, _ = case
    args = (ctx.packed, ctx.sorted_vals, ctx.offsets, TXN, TS, N_TILES)
    _, _, ncon, _ = tt.blend_tiles_plain(*args, caps=caps)
    got = tt.blend_bwd_walk_counts(*args, ncon, caps=caps, max_elems=1 << 14)
    packed, vals, offs = ctx.packed.numpy(), ctx.sorted_vals.numpy(), ctx.offsets.numpy()
    counts = np.minimum(ctx.full_counts.numpy(), caps.numpy())
    nc = ncon.numpy()
    f = np.arange(PX)
    want = dict.fromkeys(got, 0)
    for g in range(G):
        local = g % N_TILES
        px = ((local % TXN) * TS + f % TS).astype(np.float32)
        py = ((local // TXN) * TS + f // TS).astype(np.float32)
        for k in range(min(counts[g], nc[g].max())):
            r = packed[vals[offs[g] + k]]
            dx, dy = px - r[0], py - r[1]
            power = np.float32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
            alpha = np.minimum(r[8] * np.exp(power), np.float32(0.99))
            past = k >= nc[g]
            cut_p = ~past & (power > 0)
            cut_a = ~past & ~cut_p & (alpha < np.float32(1 / 255))
            want["past_last"] += int(past.sum())
            want["cut_power"] += int(cut_p.sum())
            want["cut_alpha"] += int(cut_a.sum())
            want["contributing"] += int((~past & ~cut_p & ~cut_a).sum())
    assert got == want
    assert got["contributing"] > 0 and got["past_last"] > 0 and got["cut_alpha"] > 0


def _split_scene(ts, seed=8):
    """A binned scene at tile size ts (2 views of 2 x 2 tiles), the plain
    forward's n_contrib, a random cotangent and random caps (some 0)."""
    rng = np.random.default_rng(seed)
    h = w = 2 * ts
    n = 400
    sig = rng.uniform(1.0, 4.0, (B, n))
    projs = TProj(
        means2d=torch.tensor(np.stack([rng.uniform(0, w, (B, n)), rng.uniform(0, h, (B, n))], -1),
                             dtype=torch.float32),
        depths=torch.tensor(rng.uniform(0.5, 3.0, (B, n)), dtype=torch.float32),
        conics=torch.tensor(np.stack([1 / sig**2, np.zeros((B, n)), 1 / sig**2], -1),
                            dtype=torch.float32),
        radii=torch.tensor(np.ceil(3 * sig), dtype=torch.float32))
    ctx = tt._bin_gaussians(projs, torch.tensor(rng.uniform(size=(B, n, 3)), dtype=torch.float32),
                            torch.tensor(rng.uniform(0.2, 1.0, (B, n)), dtype=torch.float32),
                            h, w, ts, 2, 2)
    g, px = ctx.full_counts.shape[0], ts * ts
    caps = torch.tensor((rng.uniform(0, 1.2, g) * ctx.full_counts.numpy()).astype(np.int32))
    caps[::3] = 0
    args = (ctx.packed, ctx.sorted_vals, ctx.offsets, 2, ts, 4)
    cot = (torch.tensor(rng.normal(size=(g, 3, px)), dtype=torch.float32),
           torch.tensor(rng.normal(size=(g, px)), dtype=torch.float32))
    return args, caps, cot


@pytest.mark.parametrize("ts", [16, 24, 32])
def test_block_walk_ends_match_walk_ends(ts):
    """H-bwd's work split: every pixel of a tile belongs to one block (16 x
    16 quadrants above 16 px), each block's walk end is min(count, its
    pixels' deepest n_contrib), and the deepest block's end is the tile's
    `_walk_ends`."""
    args, caps, _ = _split_scene(ts)
    nq, side = tt._block_split(ts)
    assert (nq, side) == ((1, ts) if ts <= 16 else (2, ts // 2))
    blocks = tt._pixel_blocks(ts)
    f = np.arange(ts * ts)
    want_blocks = (f // ts // side) * nq + (f % ts) // side
    np.testing.assert_array_equal(blocks.numpy(), want_blocks)
    assert np.bincount(want_blocks).tolist() == [side * side] * nq * nq
    for c in (None, caps):
        ncon = tt.blend_tiles_plain(*args, caps=c)[2]
        ends = tt._block_walk_ends(args[2], c, ncon, ts)
        counts = tt._capped_counts(args[2], c)
        for q in range(nq * nq):
            deepest = ncon[:, blocks == q].amax(1).long()
            assert torch.equal(ends[:, q], torch.minimum(counts, deepest))
        assert torch.equal(ends.amax(1), tt._walk_ends(args[2], c, ncon))
        assert int(ends.amax()) > 0
    assert int(ends.amin()) == 0  # the caps of 0


@pytest.mark.parametrize("ts", [16, 32])
def test_block_partials_add_up_to_plain_bwd(ts):
    """What each H-bwd block computes: the plain gradient over its own
    pixels, zero past its walk end; the blocks' partial rows added in block
    order, as the last block of a tile adds them, are the whole tile's plain
    gradient (the sums over pixels reassociated: 1e-5 x each channel's
    largest |gradient|)."""
    args, caps, (g_color, g_T) = _split_scene(ts)
    nq, _ = tt._block_split(ts)
    blocks = tt._pixel_blocks(ts)
    offsets = args[2].long()
    n = int(offsets[-1])
    tile = torch.repeat_interleave(torch.arange(offsets.shape[0] - 1), offsets.diff())
    rank = torch.arange(n) - offsets[tile]  # a binned pair's rank within its tile
    for c in (None, caps):
        _, T, ncon, _ = tt.blend_tiles_plain(*args, caps=c)
        whole = tt.blend_tiles_bwd_plain(*args, T, ncon, g_color, g_T, caps=c)
        ends = tt._block_walk_ends(args[2], c, ncon, ts)
        combined = torch.zeros_like(whole)
        for q in range(nq * nq):
            own = torch.where(blocks == q, ncon, torch.zeros_like(ncon))
            part = tt.blend_tiles_bwd_plain(*args, T, own, g_color, g_T, caps=c)
            # rows at or past the block's walk end carry none of its gradient
            assert not part[n:].any()
            assert not part[:n][rank >= ends[tile, q]].any()
            combined += part
        _assert_pairs_close(combined.numpy(), whole.numpy())


def test_deepest_first_orders_blocks_by_walk_length():
    """The kernels' block order: a permutation, walk lengths non-increasing
    along it, ties in block order."""
    lengths = torch.tensor([3, 0, 7, 3, 7, 1, 0, 3])
    order = tt._deepest_first(lengths)
    assert order.dtype == torch.int32
    assert order.tolist() == [2, 4, 0, 3, 7, 5, 1, 6]


def test_blend_gradient_matches_jax_grad():
    """BlendTiles (plain forward and backward, index_add_ scatter, the
    packed table's concatenation) against jax.grad through the JAX tile
    path's custom VJP, with respect to means2d, conics, colours and
    opacities; bound 1e-5 x each array's largest |gradient|."""
    projs, colors, opac = make_projs("dense", n=200, seed=3)
    bg = np.array([1.0, 0.5, 0.25], np.float32)
    wts = np.random.default_rng(4).normal(size=(B, 3, H, W)).astype(np.float32)
    cfg = JRasterizeConfig(tile_size=TS, tile_capacity=1024, max_tiles_per_gaussian=4,
                           backend="pallas_interpret", blend_vec=False, sort_stable=True)

    def j_loss(mx, con, col, op):
        img, over = jt.rasterize_views_binned(
            JProj(mx, jnp.asarray(projs.depths.numpy()), con, jnp.asarray(projs.radii.numpy())),
            col, op, jnp.asarray(bg), H, W, cfg)
        return jnp.sum(img * wts), over

    j_inputs = [jnp.asarray(x.numpy()) for x in (projs.means2d, projs.conics, colors, opac)]
    (_, j_over), j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3),
                                                       has_aux=True))(*j_inputs)
    t_inputs = [x.clone().requires_grad_(True) for x in (projs.means2d, projs.conics, colors, opac)]
    img, over = tt.rasterize_views_binned(
        TProj(t_inputs[0], projs.depths, t_inputs[1], projs.radii), t_inputs[2], t_inputs[3],
        torch.tensor(bg), H, W, RasterizeConfig(TS, 4))
    (img * torch.tensor(wts)).sum().backward()
    assert int(j_over) == int(over) > 0  # the footprint cap clips; nothing else does
    for name, t, j in zip(("means2d", "conics", "colors", "opacities"), t_inputs, j_grads):
        j = np.asarray(j)
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max(),
                                   err_msg=name)


def test_rasterizer_gradient_matches_jax_grad():
    """rasterize_views end to end (projection, binning, BlendTiles) against
    jax.grad through the JAX rasterize_views on its Pallas tile path
    (interpret mode, ragged=0, one capacity deep enough for every tile, M=16
    on both sides, so JAX reports overflow 0). The two projections agree to
    float noise and bin every gaussian into the same tiles (checked), so the
    bound is float noise through the projection's Jacobian: 1e-4 x each
    array's largest |gradient|."""
    rng = np.random.default_rng(6)
    n = 250
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    cams = [JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                    np.array([0.04 * b, 0, 2.0], np.float32), K, H, W)
            for b in range(B)]
    cam = {k: np.stack([np.asarray(getattr(c, a)) for c in cams]) for k, a in (
        ("wvt", "world_view_transform"), ("fpt", "full_proj_transform"),
        ("tanx", "tan_fovx"), ("tany", "tan_fovy"))}
    inputs = [rng.normal(scale=0.3, size=(B, n, 3)), rng.uniform(0.01, 0.04, (B, n, 3)),
              rng.normal(size=(B, n, 4)), rng.uniform(size=(B, n, 3)),
              rng.uniform(0.3, 1.0, (B, n))]
    inputs = [x.astype(np.float32) for x in inputs]
    bg = np.ones(3, np.float32)
    wts = rng.normal(size=(B, 3, H, W)).astype(np.float32)
    cfg = JRasterizeConfig(tile_size=TS, tile_capacity=1024, max_tiles_per_gaussian=16,
                           backend="pallas_interpret", sort_stable=True)

    j_cam = [jnp.asarray(cam[k]) for k in ("wvt", "fpt", "tanx", "tany")]

    def j_loss(means, scales, rots, cols, opac):
        img, over = j_rasterize_views(means, cols, scales, rots, opac, *j_cam, H, W,
                                      jnp.asarray(bg), config=cfg, return_overflow=True)
        return jnp.sum(img * wts), over

    (_, j_over), j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3, 4),
                                                       has_aux=True))(*map(jnp.asarray, inputs))
    t_inputs = [torch.tensor(x, requires_grad=True) for x in inputs]
    t_cam = [torch.tensor(cam[k]) for k in ("wvt", "fpt", "tanx", "tany")]
    means, scales, rots, cols, opac = t_inputs
    img, over = rasterize_views(means, cols, scales, rots, opac, *t_cam, H, W, torch.tensor(bg),
                                config=RasterizeConfig(TS, 16))
    (img * torch.tensor(wts)).sum().backward()
    assert int(j_over) == int(over) == 0
    j_radii = jax.vmap(lambda m, sc, r, a, b_, c, d: j_project(m, sc, r, a, b_, c, d, H, W).radii)(
        *map(jnp.asarray, inputs[:3]), *j_cam)
    with torch.no_grad():
        t_radii = t_project(means, scales, rots, *t_cam, H, W).radii
    np.testing.assert_array_equal(t_radii.numpy(), np.asarray(j_radii))
    names = ("means3d", "scales", "rotations", "colors", "opacities")
    for name, t, j in zip(names, t_inputs, j_grads):
        j = np.asarray(j)
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0, atol=1e-4 * np.abs(j).max(),
                                   err_msg=name)
