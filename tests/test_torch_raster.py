"""Port parity, rasterizer: EWA projection, tile binning, and the plain
version of the H-fwd blend against the JAX Pallas forward kernels run in
interpret mode (`_fwd_kernel`, `_fwd_kernel_vec`, and the ragged kernels
with per-tile caps), plus the brute-force semantics lock.

The binning and blend tests feed both packages the SAME projected gaussians
(the JAX projection, as numpy), so they compare binning and blending alone:
binning must agree exactly; the blend within the 2e-5 colour bound the JAX
kernels hold against the brute reference (BASELINE.md), with n_contrib
exact against the sequential kernel and within one rank of the vectorized
one (its transmittance products are reassociated)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.ops import rasterize_tile as jt
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.ops.projection import ProjectedGaussians as JProj
from gaussianavatar_tpu.ops.projection import project_gaussians as j_project
from gaussianavatar_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gaussianavatar_tpu.ops.rasterize_ragged import rasterize_views_ragged
from gaussianavatar_tpu.ops.rasterize_ref import rasterize_brute as j_brute

from gaussianavatar_torch.ops import rasterize_tile as tt
from gaussianavatar_torch.ops.projection import ProjectedGaussians as TProj
from gaussianavatar_torch.ops.projection import project_gaussians as t_project
from gaussianavatar_torch.ops.rasterize import RasterizeConfig
from gaussianavatar_torch.ops.rasterize_ref import rasterize_brute as t_brute

torch.set_num_threads(2)

H, W, TS = 40, 64, 16
TXN, TYN = W // TS, -(-H // TS)
N_TILES = TXN * TYN
COLOR_ATOL = 2e-5

# the JAX binning, compiled once per static shape (H, W, ts, MW, MH, stable)
j_bin = jax.jit(jt._bin_gaussians, static_argnums=(3, 4, 5, 6, 7, 8))


def make_scene(n=300, seed=0, opac_range=(0.5, 1.0), B=2, spread=0.25):
    """B views of n random gaussians (numpy), two slightly different cameras."""
    rng = np.random.default_rng(seed)
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32)
    cams = [JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                    np.array([0.05 * b, 0, 2.0], np.float32), K, H, W)
            for b in range(B)]
    means = rng.normal(scale=spread, size=(B, n, 3)).astype(np.float32)
    scales = rng.uniform(0.02, 0.09, size=(B, n, 3)).astype(np.float32)
    q = rng.normal(size=(B, n, 4)).astype(np.float32)
    opac = rng.uniform(*opac_range, size=(B, n)).astype(np.float32)
    colors = rng.uniform(size=(B, n, 3)).astype(np.float32)
    cam_arrays = {
        "wvt": np.stack([np.asarray(c.world_view_transform) for c in cams]),
        "fpt": np.stack([np.asarray(c.full_proj_transform) for c in cams]),
        "tanx": np.stack([np.asarray(c.tan_fovx) for c in cams]),
        "tany": np.stack([np.asarray(c.tan_fovy) for c in cams]),
    }
    return means, scales, q, opac, colors, cam_arrays


def jax_project(means, scales, q, cams):
    project = jax.jit(jax.vmap(
        lambda m, s, r, wvt, fpt, tx, ty: j_project(m, s, r, wvt, fpt, tx, ty, H, W)))
    projs = project(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(q), jnp.asarray(cams["wvt"]),
        jnp.asarray(cams["fpt"]), jnp.asarray(cams["tanx"]), jnp.asarray(cams["tany"]))
    return JProj(*(np.asarray(x) for x in projs))


def to_torch_proj(projs):
    return TProj(*(torch.tensor(np.asarray(x)) for x in projs))


@pytest.fixture(scope="module")
def scene():
    means, scales, q, opac, colors, cams = make_scene()
    return means, scales, q, opac, colors, cams, jax_project(means, scales, q, cams)


def test_projection_matches_jax(scene):
    means, scales, q, opac, colors, cams, jp = scene
    tp = t_project(torch.as_tensor(means), torch.as_tensor(scales), torch.as_tensor(q),
                   torch.as_tensor(cams["wvt"]), torch.as_tensor(cams["fpt"]),
                   torch.as_tensor(cams["tanx"]), torch.as_tensor(cams["tany"]), H, W)
    np.testing.assert_allclose(tp.means2d.numpy(), jp.means2d, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tp.depths.numpy(), jp.depths, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.conics.numpy(), jp.conics, rtol=1e-4, atol=1e-6)
    # radius = ceil(3 sqrt(lambda_max)): an ulp of lambda_max can move it by
    # one pixel where 3 sqrt(lambda) sits on an integer, nowhere else
    d = np.abs(tp.radii.numpy() - jp.radii)
    assert d.max() <= 1.0 and (d > 0).sum() <= max(1, d.size // 100), d.max()
    assert ((tp.radii.numpy() > 0) == (jp.radii > 0)).all()


@pytest.mark.parametrize("M", [4, 16])
def test_binning_matches_jax(scene, M):
    *_, opac, colors, cams, jp = scene
    MW = int(math.isqrt(M))
    jctx = j_bin(JProj(*(jnp.asarray(x) for x in jp)), jnp.asarray(colors),
                 jnp.asarray(opac), H, W, TS, MW, MW, True)
    tctx = tt._bin_gaussians(to_torch_proj(jp), torch.as_tensor(colors), torch.as_tensor(opac),
                             H, W, TS, MW, MW)
    np.testing.assert_array_equal(tctx.offsets.numpy(), np.asarray(jctx.offsets))
    np.testing.assert_array_equal(tctx.sorted_vals.numpy(), np.asarray(jctx.sorted_vals))
    np.testing.assert_array_equal(tctx.full_counts.numpy(), np.asarray(jctx.full_counts))
    assert int(tctx.m_dropped) == int(jctx.m_dropped)
    if M == 4:
        assert int(tctx.m_dropped) > 0  # the footprint cap clips on this scene
    np.testing.assert_array_equal(tctx.packed.numpy(), np.asarray(jctx.packed))


def _jax_blend(jctx, vec):
    """The JAX fixed-capacity Pallas forward (interpret mode) over every tile
    with a capacity that holds every binned row: per-tile outputs
    reshaped to (G, ..., ts*ts)."""
    G = int(jctx.full_counts.shape[0])
    K = max(8, -(-int(np.max(np.asarray(jctx.full_counts))) // 8) * 8)
    tiles = jnp.arange(G, dtype=jnp.int32)
    params, counts = jt._gather_tile_params(jctx, tiles, 0, K)
    blend = jt._make_pallas_blend(TXN, TS, K, True, "float32", vec)
    color, T, ncon, done = blend(params, counts, tiles % N_TILES)
    PX = TS * TS
    return (np.asarray(color).reshape(G, 3, PX), np.asarray(T).reshape(G, PX),
            np.asarray(ncon).reshape(G, PX), np.asarray(done).reshape(G, PX))


@pytest.mark.parametrize("vec", [False, True], ids=["fwd_kernel", "fwd_kernel_vec"])
def test_plain_blend_matches_pallas_forward(scene, vec):
    *_, opac, colors, cams, jp = scene
    jctx = j_bin(JProj(*(jnp.asarray(x) for x in jp)), jnp.asarray(colors),
                 jnp.asarray(opac), H, W, TS, 2, 2, True)
    jc, jT, jn, jd = _jax_blend(jctx, vec)
    tctx = tt._bin_gaussians(to_torch_proj(jp), torch.as_tensor(colors), torch.as_tensor(opac),
                             H, W, TS, 2, 2)
    tc, tT, tn, td = (x.numpy() for x in tt.blend_tiles(
        tctx.packed, tctx.sorted_vals, tctx.offsets, TXN, TS, N_TILES))
    assert jd.any(), "the scene must exercise early termination"
    np.testing.assert_allclose(tc, jc, atol=COLOR_ATOL)
    np.testing.assert_allclose(tT, jT, atol=COLOR_ATOL)
    if vec:
        assert np.abs(tn - jn).max() <= 1
    else:
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("vec", [False, True], ids=["ragged_fwd_kernel", "ragged_fwd_kernel_vec"])
def test_capped_blend_matches_ragged_kernels(scene, vec):
    """Per-tile caps (the ragged backend's data-dependent capacities)."""
    *_, opac, colors, cams, jp = scene
    tctx = tt._bin_gaussians(to_torch_proj(jp), torch.as_tensor(colors), torch.as_tensor(opac),
                             H, W, TS, 2, 2)
    rng = np.random.default_rng(7)
    counts = tctx.full_counts.numpy()
    caps = (rng.uniform(0, 1.2, size=counts.shape) * counts).astype(np.int32)
    assert (caps < counts).any() and (caps >= counts).any()
    jcfg = JRasterizeConfig(tile_size=TS, max_tiles_per_gaussian=4, backend="pallas_interpret",
                            ragged=True, ragged_chunk=16, blend_vec=vec, sort_stable=True)
    bg = np.array([1.0, 0.5, 0.0], np.float32)
    j_img, j_over = jax.jit(rasterize_views_ragged, static_argnums=(4, 5, 6))(
        JProj(*(jnp.asarray(x) for x in jp)), jnp.asarray(colors), jnp.asarray(opac),
        jnp.asarray(bg), H, W, jcfg, caps=jnp.asarray(caps))
    t_img, t_over = tt.rasterize_views_binned(
        to_torch_proj(jp), torch.as_tensor(colors), torch.as_tensor(opac), torch.as_tensor(bg),
        H, W, RasterizeConfig(TS, 4), caps=torch.as_tensor(caps))
    assert int(t_over) == int(j_over)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=COLOR_ATOL)


@pytest.mark.parametrize("capped", [False, True], ids=["uncapped", "capped"])
def test_walk_counts_match_sequential_walk(scene, capped):
    """`blend_walk_counts` (the work the bound of H-fwd is computed from)
    against the per-pixel walk written out row by row in numpy, as the
    kernel walks: every pair is classified exactly, and the walk ends where
    the blend's own `done` and n_contrib say it does."""
    *_, opac, colors, cams, jp = scene
    ctx = tt._bin_gaussians(to_torch_proj(jp), torch.as_tensor(colors), torch.as_tensor(opac),
                            H, W, TS, 2, 2)
    args = (ctx.packed, ctx.sorted_vals, ctx.offsets, TXN, TS, N_TILES)
    counts = ctx.full_counts.numpy().astype(np.int64)
    caps = None
    if capped:
        caps = (np.random.default_rng(5).uniform(0, 1.2, counts.shape) * counts).astype(np.int32)
        counts = np.minimum(counts, caps)
        caps = torch.as_tensor(caps)
    got = tt.blend_walk_counts(*args, caps=caps, max_elems=1 << 14)

    packed, vals, offs = ctx.packed.numpy(), ctx.sorted_vals.numpy(), ctx.offsets.numpy()
    f = np.arange(TS * TS)
    want = dict.fromkeys(got, 0)
    for g in range(counts.shape[0]):
        local = g % N_TILES
        px = ((local % TXN) * TS + f % TS).astype(np.float32)
        py = ((local // TXN) * TS + f // TS).astype(np.float32)
        T = np.ones(TS * TS, np.float32)
        live = np.ones(TS * TS, bool)
        for k in range(counts[g]):
            r = packed[vals[offs[g] + k]]
            dx, dy = px - r[0], py - r[1]
            power = np.float32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
            alpha = np.minimum(r[8] * np.exp(power), np.float32(0.99))
            cut_p = live & (power > 0)
            cut_a = live & ~cut_p & (alpha < np.float32(1 / 255))
            test_T = T * (np.float32(1) - alpha)
            passed = live & ~cut_p & ~cut_a
            term = passed & (test_T < np.float32(1e-4))
            blend = passed & ~term
            want["cut_power"] += int(cut_p.sum())
            want["cut_alpha"] += int(cut_a.sum())
            want["terminating"] += int(term.sum())
            want["blended"] += int(blend.sum())
            T = np.where(blend, test_T, T)
            live &= ~term
    assert got == want
    done = tt.blend_tiles_plain(*args, caps=caps)[3]
    assert got["terminating"] == int(done.sum()) > 0
    assert got["blended"] > 0 and got["cut_alpha"] > 0


def test_tile_render_matches_brute():
    """The brute-force semantics lock. The port's brute render equals the
    JAX one, its tile render equals the JAX tile render (xla blend, one tier
    deep enough for every tile), and the tile render equals the brute one
    except on exactly the pixels where the JAX tile render differs from the
    JAX brute one: CUDA's getRect tile rect [(m - r)/ts, (m + r + ts - 1)/ts)
    leaves out pixel rows a radius reaches past the last full tile, which
    the brute render (every gaussian, every pixel) keeps."""
    means, scales, q, opac, colors, cams = make_scene(n=60, seed=3, opac_range=(0.05, 0.3),
                                                      spread=0.4)
    jp = jax_project(means, scales, q, cams)
    bg = np.ones(3, np.float32)
    t_img, t_over = tt.rasterize_views_binned(
        to_torch_proj(jp), torch.as_tensor(colors), torch.as_tensor(opac), torch.as_tensor(bg),
        H, W, RasterizeConfig(TS, 16))
    assert int(t_over) == 0
    j_img, j_over = jax.jit(jt.rasterize_views_binned, static_argnums=(4, 5, 6))(
        JProj(*(jnp.asarray(x) for x in jp)), jnp.asarray(colors), jnp.asarray(opac),
        jnp.asarray(bg), H, W,
        JRasterizeConfig(tile_size=TS, tile_capacity=256, max_tiles_per_gaussian=16,
                         backend="xla"))
    assert int(j_over) == 0
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=COLOR_ATOL)
    j_brute_jit = jax.jit(j_brute, static_argnums=(4, 5))
    for b in range(means.shape[0]):
        one = lambda x: x[b]
        jb = np.asarray(j_brute_jit(JProj(*(jnp.asarray(one(x)) for x in jp)),
                                    jnp.asarray(colors[b]), jnp.asarray(opac[b]),
                                    jnp.asarray(bg), H, W))
        tb = t_brute(TProj(*(torch.tensor(one(x)) for x in jp)), torch.as_tensor(colors[b]),
                     torch.as_tensor(opac[b]), torch.as_tensor(bg), H, W).numpy()
        np.testing.assert_allclose(tb, jb, atol=COLOR_ATOL)
        j_crop = np.abs(np.asarray(j_img[b]) - jb) > COLOR_ATOL
        t_crop = np.abs(t_img[b].numpy() - tb) > COLOR_ATOL
        np.testing.assert_array_equal(t_crop, j_crop)
