#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gaussianavatar_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits nonzero otherwise):
  1. setup: the card's name and power limit, torch / CUDA / nvcc versions,
     and the build of every CUDA kernel of the port from csrc/ (timed);
  2. H-fwd against its plain PyTorch version on a random scene at the render
     shapes (115k gaussians per view, 4 views of 1024^2, 32px tiles, M=4),
     uncapped and with random per-tile caps;
  3. the stage-1 novel-pose render (engine/inference.make_renderer) of a
     synthetic avatar at the canonical widths (query posmap 512, bf16
     decoder, random weights from a seed) on 32 poses, 4 per call at
     1024^2, with the kernel's launch count read around that run; then one
     batch against the same render with the plain blend, and the kernel
     timed on that batch's own binned inputs beside its bound;
  4. H-bwd against its plain version on a random scene at the render
     shapes, uncapped and capped, opacity 1 (the 0.99 clamp bites);
  5. stage-1 training at the canonical widths (query posmap 512, input 128,
     c_geom 64, hsize 128, bf16 decoder, B=2, 512^2 frames, 32px tiles,
     M=9): the port's writer makes 8 frames, `python -m
     gaussianavatar_torch.train` (its `main`) takes 30 steps, with both
     kernels' launch counts read around it; then H-fwd and H-bwd against
     their plain versions on the last step's own batch, each timed beside
     its bound;
  6. on phase 5's output, the rest of the stage-1 path through the users'
     entry points, each with the launch counts read around it: training
     resumed with `--checkpoint_epochs 8` to epoch 10 (8 steps: the
     iteration and the optimizer's counts go on from 30, the loss stays
     near where it was, both kernels launch once per step), `python -m
     gaussianavatar_torch.eval` on the 4 test frames (finite PSNR / SSIM,
     one H-fwd launch per 4 frames, frames/s), and `python -m
     gaussianavatar_torch.render_novel_view` (4 orbit frames);
  7. stage 2 on phase 6's output at the same widths (c_pose 64, nf 32),
     through the users' entry points, the launch counts read around each:
     `export_stage_1`, `gen_pose_map_frames --size 128`, 30 steps of
     `train --train_stage 2` (H-fwd and H-bwd exactly once per step; the
     last step's inputs of both held against their plain versions and
     timed beside their bounds; steady it/s, peak memory, pose_loss), eval
     of the 4 test frames (one H-fwd launch, frames/s) and 4 orbit frames
     of novel view (one);
  8. the rest of the user's pipeline on phase 5's data, through the users'
     entry points, the launch counts read around each: (a) 30 stage-1
     steps with the LPIPS term from the first step (random weights of the
     exact layout from a seed under a project's assets/lpips; the `lpips`
     event "active", `vgg` finite at every logged step, H-fwd and H-bwd
     once per step and held against their plain versions on the last
     step's batch, LPIPS on the card against LPIPS on the CPU, its time,
     it/s and peak memory beside phase 5's), then eval with a numeric
     `lpips:` line; (b) `gen_pose_map_cano --synthetic --sizes 512 128`
     (the valid pixels at 512 are phase 5's gaussians) and
     `sample_romp2gsavatar` on a ROMP capture made of phase 5's frames
     (tree, 80/20 split, poses); (c) `render_pred_smpl --synthetic` over 8
     frames of 512^2 with the 48 x 32 body (one H-fwd launch per frame,
     the last frame's blend held against the plain version, frames/s);
     (d) `export_avatar_ply` of phase 5's checkpoint at frame 0, read back
     and held against the gaussians the renderer draws for that frame.
It prints one JSON line of per-kernel numbers, then, last,
{"ok": true, "device": {...}}. It needs CUDA and the repository around it.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): HBM bandwidth and FP32 outside the
# tensor cores — the blend is f32 elementwise work
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# f32 operations H-fwd does per (row, pixel) pair it walks, by how the pair
# ends (blend_walk_counts classifies them on the run's own inputs):
#   cut by power > 0: dx, dy (2), power (9), the test (1)              12
#   cut by alpha < 1/255: the above, exp (1), opacity * exp and the
#     clamp (2), the test (1)                                          16
#   the terminating row: the above, 1 - alpha and T * (1 - alpha) (2),
#     the test (1)                                                     19
#   blended: the above, the weight (1), three colour multiply-adds (6) 26
# exp counts as one operation, so the bound errs low.
BLEND_FLOPS = {"cut_power": 12, "cut_alpha": 16, "terminating": 19, "blended": 26}

# f32 operations the blend's gradient needs per (row, pixel) pair, by how
# the pair ends (blend_bwd_walk_counts classifies them on the run's own
# inputs):
#   cut by power > 0: dx, dy (2), power (9), the two tests (2)          13
#   cut by alpha < 1/255: the above, exp, opacity * exp, the clamp and
#     the test (4)                                                      17
#   contributing: 17, then 1 - alpha, T / (1 - alpha), the weight (3),
#     dalpha (13), the suffix colours (9), dpow (2), the nine integrands
#     (21) and their sums over the tile (9)                             74
# A pair past its pixel's n_contrib ("past_last") needs none: H-bwd walks
# it (a tile walks down to its deepest pixel's contributor), but a pixel
# could start its walk at its own n_contrib, so the bound charges it 0.
BWD_FLOPS = {"cut_power": 13, "cut_alpha": 17, "contributing": 74}
# H-bwd against its plain version: per pair and channel within this share
# of the channel's largest |gradient|. Both round every per-pixel term the
# same way (-fmad=false); only the sums over a tile's pixels run in another
# order (the kernel: warp shuffles, then warps in a fixed order).
TOL_BWD_REL = 1e-5

# tolerances of the kernel against its plain version on the same inputs.
# Both round after every multiply and add in the same order (the kernel is
# built with -fmad=false) and take the transmittance as a sequential product
# (torch.cumprod over a non-innermost dimension scans sequentially), so the
# gating decisions, n_contrib, done and T agree exactly; only the colour sum
# is reassociated (the plain version sums rows with a matmul).
TOL_COLOR = 2e-5
TOL_T = 1e-6
TOL_IMAGE = 2e-5

# the CUDA kernels each main path runs
RENDER_KERNELS = ("blend_fwd",)
TRAIN_KERNELS = ("blend_fwd", "blend_bwd")
TRAIN_STEPS = 30


def _fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare(out_k, out_p):
    """Max abs diffs of colour and T, and the n_contrib / done mismatches."""
    ck, tk, nk, dk = out_k
    cp, tp, np_, dp = out_p
    return {
        "color": float((ck - cp).abs().max()),
        "T": float((tk - tp).abs().max()),
        "ncon_mismatch": int((nk != np_).sum()),
        "done_mismatch": int((dk != dp).sum()),
    }


def _check_blend(label, res):
    print(f"  {label}: max|d color| {res['color']:.3e} (tol {TOL_COLOR:g}), "
          f"max|d T| {res['T']:.3e} (tol {TOL_T:g}), n_contrib mismatches "
          f"{res['ncon_mismatch']} (tol 0), done mismatches {res['done_mismatch']} (tol 0)")
    if (res["color"] > TOL_COLOR or res["T"] > TOL_T or res["ncon_mismatch"]
            or res["done_mismatch"]):
        _fail(f"H-fwd disagrees with its plain version ({label})")


def _blend_bound(args, caps):
    """Least time for the blend on these inputs: bytes each input read once
    and each output written once over HBM bandwidth, and the f32 operations
    the walk of these inputs needs over the FP32 peak; the larger of the two."""
    import torch

    from gaussianavatar_torch.ops.rasterize_tile import blend_walk_counts

    packed, sorted_vals, offsets, txn, ts, n_tiles = args
    counts = (offsets[1:] - offsets[:-1]).long()
    if caps is not None:
        counts = torch.minimum(counts, caps.long().clamp_min(0))
    G, PX = counts.shape[0], ts * ts
    pairs = int(counts.sum())
    # positions of the pairs the tiles blend, and the distinct rows they read
    tile = torch.repeat_interleave(torch.arange(G, device=offsets.device), counts)
    first = torch.cumsum(counts, 0) - counts
    pos = offsets[:-1].long()[tile] + torch.arange(pairs, device=offsets.device) - first[tile]
    rows = int(torch.unique(sorted_vals[pos]).numel())
    bytes_ = 4 * pairs + 64 * rows + 4 * (G + 1) + (4 * G if caps is not None else 0) \
        + G * PX * 4 * 6
    walk = blend_walk_counts(*args, caps=caps)
    flops = float(sum(BLEND_FLOPS[k] * n for k, n in walk.items()))
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"pairs": pairs, "rows": rows, "bytes": bytes_, "walk": walk, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _print_walk(label, bound):
    walk = bound["walk"]
    total = sum(walk.values())
    print(f"  {label}: (row, pixel) pairs walked {total}: " + ", ".join(
        f"{k} {n} ({100 * n / max(total, 1):.1f}%)" for k, n in walk.items())
        + f"; {bound['flops'] / 1e9:.3f} GFLOP, {bound['bytes'] / 1e6:.1f} MB")


def phase_setup():
    import torch

    from gaussianavatar_torch.utils import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    print("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s (wall, parallel nvcc)")
    for name, res in built.items():
        print(f"  {name}: nvcc {res.seconds:.1f} s -> {os.path.relpath(res.path, REPO)}")
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("   ", line.strip())
    return card


def phase_random_scene(device):
    """H-fwd vs its plain version on a random scene at the render shapes."""
    import torch

    from gaussianavatar_torch.ops.projection import ProjectedGaussians
    from gaussianavatar_torch.ops.rasterize_tile import (
        _bin_gaussians, blend_tiles, blend_tiles_plain,
    )

    B, N, H, W, ts, MW = 4, 115_000, 1024, 1024, 32, 2
    g = torch.Generator(device="cpu").manual_seed(0)
    u = lambda *s: torch.rand(s, generator=g)
    means2d = torch.stack([u(B, N) * W, u(B, N) * H], -1)
    sigma = 0.8 + 2.5 * u(B, N)                      # footprint sigma in px
    rho = (u(B, N) - 0.5) * 0.8
    cxx, cyy = sigma**2, (sigma * (0.6 + 0.8 * u(B, N)))**2
    cxy = rho * torch.sqrt(cxx * cyy)
    det = cxx * cyy - cxy * cxy
    conics = torch.stack([cyy / det, -cxy / det, cxx / det], -1)
    lam = 0.5 * (cxx + cyy) + torch.sqrt(torch.clamp_min((0.5 * (cxx - cyy))**2 + cxy**2, 0.1))
    projs = ProjectedGaussians(means2d=means2d, depths=0.5 + 3 * u(B, N), conics=conics,
                               radii=torch.ceil(3 * torch.sqrt(lam)))
    projs = ProjectedGaussians(*(x.to(device) for x in projs))
    colors = u(B, N, 3).to(device)
    opac = (0.3 + 0.7 * u(B, N)).to(device)

    ctx = _bin_gaussians(projs, colors, opac, H, W, ts, MW, MW)
    txn = W // ts
    n_tiles = txn * (H // ts)
    args = (ctx.packed, ctx.sorted_vals, ctx.offsets, txn, ts, n_tiles)
    print(f"  random scene: {B}x{N} gaussians, {int(ctx.offsets[-1])} binned pairs, "
          f"max/mean per tile {int(ctx.full_counts.max())}/{float(ctx.full_counts.float().mean()):.0f}")
    caps = (torch.rand(ctx.full_counts.shape, generator=g)
            * 1.2 * ctx.full_counts.cpu().float()).int().to(device)
    for label, c in (("uncapped", None), ("capped", caps)):
        out_k = blend_tiles(*args, caps=c)
        out_p = blend_tiles_plain(*args, caps=c)
        torch.cuda.synchronize()
        _check_blend(label, _compare(out_k, out_p))
        ms = _time_ms(lambda: blend_tiles(*args, caps=c), reps=20)
        plain_ms = _time_ms(lambda: blend_tiles_plain(*args, caps=c), reps=3, warmup=1)
        bound = _blend_bound(args, c)
        _print_walk(f"random scene, {label}", bound)
        print(f"  random scene, {label}: {bound['pairs']} pairs blended, kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) "
              "per 4-view batch (no PyTorch library call computes this blend)")


def make_slice(device):
    """The main path's setup: a synthetic avatar at the canonical widths
    (query posmap 512, input posmap 128, c_geom 64, hsize 128, bf16 decoder,
    random weights from seed 0), its stage-1 renderer from `make_renderer`,
    and batches of 4 of 32 poses from `synthetic_pose`, 1024^2, white
    background, a camera that frames the body."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from gaussianavatar_torch.config import Config, ModelParams, NetworkParams, \
        OptimizationParams, RasterParams
    from gaussianavatar_torch.engine.inference import InferenceBundle, make_renderer
    from gaussianavatar_torch.engine.setup import AvatarBundle
    from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
    from gaussianavatar_torch.ops.camera import Camera
    from gaussianavatar_torch.utils.synthetic import synthetic_body, synthetic_pose

    H = W = 1024
    B, n_poses = 4, 32
    cfg = Config(ModelParams(query_posmap_size=512, inp_posmap_size=128),
                 NetworkParams(), OptimizationParams(), RasterParams())
    t0 = time.perf_counter()
    body, uv = synthetic_body(n_rings=48, n_cols=32)
    J = body.parents.shape[0]
    assets = build_avatar_assets(body, uv.verts, uv.uvs, uv.faces_v, uv.faces_vt,
                                 np.zeros(J * 3, np.float32), np.zeros(4, np.float32),
                                 query_res=cfg.model.query_posmap_size, device=device)
    torch.manual_seed(0)  # nn.Linear / nn.Conv2d default init draws from it
    poses = np.stack([synthetic_pose(body, t / n_poses) for t in range(n_poses)])
    net = AvatarNet(
        num_frames=n_poses, pose_dim=J * 3, c_geom=cfg.net.c_geom,
        inp_posmap_size=cfg.model.inp_posmap_size, hsize=cfg.net.hsize,
        compute_dtype="bfloat16" if cfg.net.bf16_decoder else "float32",
        pose_init=poses, generator=torch.Generator().manual_seed(0), device=device,
    ).eval()
    inf = InferenceBundle(cfg, AvatarBundle(body.to(device), assets, net, frames=None), epoch=0)
    print(f"  avatar: {assets.num_valid} gaussians (+{assets.query_points.shape[0] - assets.num_valid}"
          f" padding), query {assets.query_res}, bf16 decoder, set up in "
          f"{time.perf_counter() - t0:.1f} s")

    K = np.array([[1120.0, 0, W / 2], [0, 1120.0, H / 2], [0, 0, 1]], np.float32)
    cam = Camera.from_extrinsics(np.eye(3, dtype=np.float32),
                                 np.array([0.0, -0.8, 1.6], np.float32), K, H, W, device=device)
    rep = lambda x: x[None].expand(B, *x.shape).contiguous()

    def batch_for(start):
        idx = (np.arange(B) + start) % n_poses
        return {"pose_idx": idx, "pose_data": poses[idx],
                "transl_data": np.zeros((B, 3), np.float32),
                "world_view_transform": rep(cam.world_view_transform),
                "full_proj_transform": rep(cam.full_proj_transform),
                "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)}

    # scales of a trained avatar are ~1cm; the warm-up factor at iteration 10
    # gives random-weight decoder scales (~0.5) that magnitude
    return SimpleNamespace(render=make_renderer(inf, H, W, with_overflow=True),
                           batch_for=batch_for, inf=inf, H=H, W=W, B=B, n_poses=n_poses,
                           iteration=10)


def phase_slice(device, card):
    """The stage-1 novel-pose render of a canonical-width avatar."""
    import torch

    from gaussianavatar_torch.ops import rasterize_tile
    from gaussianavatar_torch.utils.cuda_build import LAUNCHES

    s = make_slice(device)
    render, batch_for, it = s.render, s.batch_for, s.iteration
    H, W, B, n_poses = s.H, s.W, s.B, s.n_poses
    torch.cuda.reset_peak_memory_stats()
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    imgs, overflow = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, n_poses, B):
        img, ov = render(batch_for(start), it)
        imgs.append(img)
        overflow += int(ov)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  rendered {n_poses} poses at {H}x{W} in {n_poses // B} calls: "
          f"{n_poses / wall:.2f} frames/s (first call included), peak memory "
          f"{peak_gb:.2f} GiB, footprint overflow {overflow} pairs, on {card}")
    print(f"  kernel launches in the main path: {counts}")
    for name in RENDER_KERNELS:
        if counts[name] < 1:
            _fail(f"the main path did not launch {name}")
    launches = counts["blend_fwd"]
    imgs = torch.cat(imgs)
    if imgs.shape != (n_poses, 3, H, W) or not bool(torch.isfinite(imgs).all()):
        _fail(f"render output not finite or of shape {tuple(imgs.shape)}")
    body_frac = float((imgs < 0.99).any(1).float().mean())
    print(f"  images finite, {body_frac * 100:.1f}% of pixels covered by the avatar")
    if body_frac < 0.01:
        _fail("images are (almost) all background")

    # steady-state rate: the same calls again, everything built and warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, n_poses, B):
        render(batch_for(start), it)
    torch.cuda.synchronize()
    fps = n_poses / (time.perf_counter() - t0)
    print(f"  steady state: {fps:.2f} frames/s at {H}x{W}, B={B}, on {card}")

    # one batch again, recording the blend's inputs, then with the plain blend
    real = rasterize_tile.blend_tiles
    rec = {}

    def recording(*a, **kw):
        rec["args"], rec["caps"] = a, kw.get("caps", a[6] if len(a) > 6 else None)
        return real(*a, **kw)

    try:
        rasterize_tile.blend_tiles = recording
        img_k = render(batch_for(0), it)[0]
        rasterize_tile.blend_tiles = rasterize_tile.blend_tiles_plain
        img_p = render(batch_for(0), it)[0]
    finally:
        rasterize_tile.blend_tiles = real
    d_img = float((img_k - img_p).abs().max())
    print(f"  one batch, kernel vs plain blend: max|d image| {d_img:.3e} (tol {TOL_IMAGE:g})")
    if d_img > TOL_IMAGE:
        _fail("the render through H-fwd disagrees with the plain blend")

    args, caps = rec["args"][:6], rec["caps"]
    out_k = real(*args)
    out_p = rasterize_tile.blend_tiles_plain(*args)
    res = _compare(out_k, out_p)
    _check_blend("main-path batch", res)
    ms = _time_ms(lambda: real(*args), reps=20)
    plain_ms = _time_ms(lambda: rasterize_tile.blend_tiles_plain(*args), reps=3, warmup=1)
    bound = _blend_bound(args, caps)
    print(f"  main-path batch: {bound['pairs']} binned pairs, {bound['rows']} gaussian rows")
    _print_walk("main-path batch", bound)
    print(f"  H-fwd {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}) per 4-view batch; no library call; on {card}")
    return {
        "name": "blend_fwd", "route": "cuda",
        "source": "gaussianavatar_torch/csrc/blend_fwd.cu",
        "replaces": "gaussianavatar_tpu/ops/rasterize_tile.py:550",
        "launches": launches,
        "max_abs_err": max(res["color"], res["T"]),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None,
    }


def _bwd_compare(label, out_k, out_p):
    """Per-channel max |kernel - plain| against TOL_BWD_REL x the channel's
    largest |value|; fails on a mismatch or a non-finite value."""
    from gaussianavatar_torch.ops.rasterize_tile import GRAD_CHANNELS

    if not (bool(out_k.isfinite().all()) and bool(out_p.isfinite().all())):
        _fail(f"H-bwd gradients not finite ({label})")
    d = (out_k - out_p).abs().amax(0)
    scale = out_p.abs().amax(0)
    rel = float((d / scale.clamp_min(1e-30)).max())
    print(f"  {label}: max|d| / max|grad| per channel " + ", ".join(
        f"{c} {float(x):.2e}/{float(m):.2e}" for c, x, m in zip(GRAD_CHANNELS, d, scale))
        + f"; worst {rel:.2e} (tol {TOL_BWD_REL:g})")
    if bool((d > TOL_BWD_REL * scale).any()):
        _fail(f"H-bwd disagrees with its plain version ({label})")
    return float(d.max())


def _bwd_bound(args, caps, n_contrib):
    """Least time for the blend's gradient on these inputs: each input read
    once (an id and a 64-byte row per pair below a tile's deepest
    contributor, finalT / n_contrib / the cotangent per pixel, offsets and
    caps) and a (9 x f32) gradient written once per such pair (pairs past
    it are zero); the f32 operations these inputs need (BWD_FLOPS, pairs
    past their pixel's last contributor charged nothing); the larger of
    the two."""
    import torch

    from gaussianavatar_torch.ops.rasterize_tile import _walk_ends, blend_bwd_walk_counts

    packed, sorted_vals, offsets, txn, ts, n_tiles = args
    ends = _walk_ends(offsets, caps, n_contrib)
    G, PX = ends.shape[0], ts * ts
    pairs = int(ends.sum())
    tile = torch.repeat_interleave(torch.arange(G, device=offsets.device), ends)
    first = torch.cumsum(ends, 0) - ends
    pos = offsets[:-1].long()[tile] + torch.arange(pairs, device=offsets.device) - first[tile]
    rows = int(torch.unique(sorted_vals[pos]).numel())
    bytes_ = 4 * pairs + 64 * rows + 4 * (G + 1) + (4 * G if caps is not None else 0) \
        + G * PX * 24 + pairs * 36
    walk = blend_bwd_walk_counts(*args, n_contrib, caps=caps)
    flops = float(sum(BWD_FLOPS[k] * walk[k] for k in BWD_FLOPS))
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"pairs": pairs, "rows": rows, "bytes": bytes_, "walk": walk, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _time_bwd(label, bwd_args, caps, card):
    """H-bwd and its plain version timed on the same inputs, with the bound."""
    from gaussianavatar_torch.ops.rasterize_tile import blend_tiles_bwd, blend_tiles_bwd_plain

    ms = _time_ms(lambda: blend_tiles_bwd(*bwd_args, caps=caps), reps=20)
    plain_ms = _time_ms(lambda: blend_tiles_bwd_plain(*bwd_args, caps=caps), reps=1, warmup=1)
    bound = _bwd_bound(bwd_args[:6], caps, bwd_args[7])
    _print_walk(f"{label} (H-bwd walk)", bound)
    print(f"  {label}: {bound['pairs']} pairs below the deepest contributors, "
          f"{bound['rows']} gaussian rows; H-bwd {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); no library call; on {card}")
    return ms, plain_ms, bound


def phase_bwd_random_scene(device, card):
    """H-bwd vs its plain version on a random scene at the render shapes,
    every gaussian of opacity 1, uncapped and capped."""
    import torch

    from gaussianavatar_torch.ops.projection import ProjectedGaussians
    from gaussianavatar_torch.ops.rasterize_tile import (
        _bin_gaussians, blend_tiles, blend_tiles_bwd, blend_tiles_bwd_plain,
    )

    B, N, H, W, ts, MW = 4, 115_000, 1024, 1024, 32, 2
    g = torch.Generator(device="cpu").manual_seed(1)
    u = lambda *s: torch.rand(s, generator=g)
    sigma = 0.8 + 2.5 * u(B, N)
    projs = ProjectedGaussians(
        means2d=torch.stack([u(B, N) * W, u(B, N) * H], -1), depths=0.5 + 3 * u(B, N),
        conics=torch.stack([1 / sigma**2, torch.zeros(B, N), 1 / sigma**2], -1),
        radii=torch.ceil(3 * sigma))
    projs = ProjectedGaussians(*(x.to(device) for x in projs))
    ctx = _bin_gaussians(projs, u(B, N, 3).to(device), torch.ones(B, N, device=device),
                         H, W, ts, MW, MW)
    txn = W // ts
    # the binned prefix of the sorted table, as BlendTiles.backward passes it
    binned = ctx.sorted_vals[:int(ctx.offsets[-1])]
    args = (ctx.packed, binned, ctx.offsets, txn, ts, txn * (H // ts))
    G = ctx.full_counts.shape[0]
    caps = (torch.rand(G, generator=g) * 1.2 * ctx.full_counts.cpu().float()).int().to(device)
    g_color = (torch.rand((G, 3, ts * ts), generator=g) - 0.5).to(device)
    g_T = (torch.rand((G, ts * ts), generator=g) - 0.5).to(device)
    for label, c in (("uncapped", None), ("capped", caps)):
        _, T, ncon, _ = blend_tiles(*args, caps=c)
        bwd_args = (*args, T, ncon, g_color, g_T)
        out_k = blend_tiles_bwd(*bwd_args, caps=c)
        out_k2 = blend_tiles_bwd(*bwd_args, caps=c)
        out_p = blend_tiles_bwd_plain(*bwd_args, caps=c)
        torch.cuda.synchronize()
        if not torch.equal(out_k, out_k2):
            _fail(f"H-bwd differs between two runs on the same inputs ({label})")
        _bwd_compare(f"random scene, opacity 1, {label}", out_k, out_p)
        _time_bwd(f"random scene, {label}", bwd_args, c, card)


def _train_argv(data, out):
    return ["-s", data, "-m", out, "--train_stage", "1", "--dataset_type", "synthetic",
            "--pose_op_start_iter", "0", "--no_lpips"]


def _run_counted(fn, *args):
    """fn(*args) with every kernel's launch count set to 0 just before and
    read just after (the device synchronised) -> (result, counts, wall s)."""
    import torch

    from gaussianavatar_torch.utils.cuda_build import LAUNCHES

    for name in LAUNCHES:
        LAUNCHES[name] = 0
    t0 = time.perf_counter()
    result = fn(*args)
    torch.cuda.synchronize()
    return result, dict(LAUNCHES), time.perf_counter() - t0


def phase_rest_of_path(card, work):
    """Resume, eval and novel view on phase 5's output, through the CLIs."""
    import torch

    from gaussianavatar_torch import eval as eval_cli, render_novel_view, train as train_cli
    from gaussianavatar_torch.engine import checkpoint as ckpt

    data, out = os.path.join(work, "data"), os.path.join(work, "out")
    metrics = os.path.join(out, "metrics.jsonl")
    before = [json.loads(line) for line in open(metrics) if '"step"' in line]
    saved = torch.load(os.path.join(ckpt.ckpt_dir(out, 8), ckpt.TRAIN_NAME), weights_only=True)
    print(f"  iteration_8 holds iteration {saved['iteration']}, optimizer counts "
          f"net {saved['optimizer']['net']['count']}, geo {saved['optimizer']['geo']['count']}, "
          f"embed {int(saved['optimizer']['embed']['step_count'])}")
    if saved["iteration"] != TRAIN_STEPS or saved["optimizer"]["net"]["count"] != TRAIN_STEPS:
        _fail("phase 5's checkpoint does not hold its iteration and optimizer count")

    # resume: epochs 9 and 10, 4 steps each
    resumed_steps = 2 * 4
    _, resume_counts, wall = _run_counted(
        train_cli.main, _train_argv(data, out) + ["--checkpoint_epochs", "8", "--epochs", "10"])
    print(f"  kernel launches in the resumed run: {resume_counts} ({resumed_steps} steps, "
          f"{wall:.1f} s in all)")
    for name in TRAIN_KERNELS:
        if resume_counts[name] != resumed_steps:
            _fail(f"the resumed run launched {name} {resume_counts[name]} times, not once per "
                  "step")
    after = [json.loads(line) for line in open(metrics) if '"step"' in line][len(before):]
    end = torch.load(os.path.join(ckpt.ckpt_dir(out, 10), ckpt.TRAIN_NAME), weights_only=True)
    last, first = before[-1], after[0]
    print(f"  resumed: first logged step {first['step']} (loss {first['total']:.5f}, w_rgl "
          f"{first['w_rgl']:g}) after step {last['step']} (loss {last['total']:.5f}); "
          f"iteration_10 holds iteration {end['iteration']}, net count "
          f"{end['optimizer']['net']['count']}")
    if first["step"] != TRAIN_STEPS + 1 or end["iteration"] != TRAIN_STEPS + resumed_steps \
            or end["optimizer"]["net"]["count"] != TRAIN_STEPS + resumed_steps:
        _fail("the resumed run did not go on from the restored iteration and counts")
    if not all(math.isfinite(r["total"]) for r in after) \
            or not 0.5 <= first["total"] / last["total"] <= 2.0:
        _fail("the resumed loss is not finite or not within 2x of the loss before")

    result, counts, wall = _run_counted(eval_cli.main, ["-m", out])
    n_batches = -(-result["frames"] // eval_cli.EVAL_B)
    print(f"  eval: {result['frames']} test frames of 512x512, PSNR {result['psnr']:.3f} "
          f"SSIM {result['ssim']:.5f}, overflow {result['raster_overflow']} pairs, "
          f"{result['frames'] / result['render_s']:.2f} frames/s in the render calls "
          f"({wall:.1f} s in all, setup included), launches {counts}, on {card}")
    lines = open(os.path.join(out, "test_free", "results.txt")).read()
    if not all(math.isfinite(result[k]) for k in ("psnr", "ssim")) \
            or "psnr:" not in lines or "ssim:" not in lines:
        _fail("eval wrote no finite PSNR / SSIM")
    if counts["blend_fwd"] != n_batches:
        _fail(f"eval launched H-fwd {counts['blend_fwd']} times for {n_batches} batches")
    eval_counts = counts

    _, counts, wall = _run_counted(render_novel_view.main, ["-m", out, "--frames", "4"])
    pngs = sorted(os.listdir(os.path.join(out, "novel_view", "pose_0")))
    print(f"  novel view: {pngs} in {wall:.1f} s, launches {counts}")
    if pngs != [f"{i:05d}.png" for i in range(4)] or counts["blend_fwd"] < 1:
        _fail("the novel-view render did not write 4 frames through H-fwd")
    # launches over the three runs
    return {name: resume_counts[name] + eval_counts[name] + counts[name] for name in counts}


class _KernelRecorder:
    """While active, the blend wrappers keep their last call's inputs (they
    launch as before)."""

    def __enter__(self):
        from gaussianavatar_torch.ops import rasterize_tile

        self.mod = rasterize_tile
        self.real_fwd, self.real_bwd = rasterize_tile.blend_tiles, rasterize_tile.blend_tiles_bwd
        self.rec = {}

        def fwd(*a, **kw):
            self.rec["fwd_args"], self.rec["fwd_kw"] = a, kw
            return self.real_fwd(*a, **kw)

        def bwd(*a, **kw):
            self.rec["args"], self.rec["kw"] = a, kw
            return self.real_bwd(*a, **kw)

        rasterize_tile.blend_tiles, rasterize_tile.blend_tiles_bwd = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.mod.blend_tiles, self.mod.blend_tiles_bwd = self.real_fwd, self.real_bwd


def _hold_train_batch(rec, card, label):
    """H-fwd and H-bwd against their plain versions on the inputs a training
    step gave them (`rec` from _KernelRecorder), each timed beside its
    bound. -> (H-fwd's error, H-bwd's error, {fwd_ms, fwd_plain_ms,
    fwd_bound, bwd_ms, bwd_plain_ms, bwd_bound})."""
    import torch

    from gaussianavatar_torch.ops.rasterize_tile import (
        blend_tiles, blend_tiles_bwd, blend_tiles_bwd_plain, blend_tiles_plain,
        scatter_pair_grads,
    )

    fwd_args = tuple(a.detach() if torch.is_tensor(a) else a for a in rec["fwd_args"][:6])
    fwd_caps = rec["fwd_kw"].get("caps", rec["fwd_args"][6] if len(rec["fwd_args"]) > 6
                                 else None)
    fwd_res = _compare(blend_tiles(*fwd_args, caps=fwd_caps),
                       blend_tiles_plain(*fwd_args, caps=fwd_caps))
    _check_blend(f"{label}, H-fwd", fwd_res)
    fwd_ms = _time_ms(lambda: blend_tiles(*fwd_args, caps=fwd_caps), reps=20)
    fwd_plain_ms = _time_ms(lambda: blend_tiles_plain(*fwd_args, caps=fwd_caps), reps=3, warmup=1)
    fwd_bound = _blend_bound(fwd_args, fwd_caps)
    _print_walk(f"{label} (H-fwd walk)", fwd_bound)
    print(f"  {label}: H-fwd {fwd_ms:.4f} ms, plain {fwd_plain_ms:.3f} ms, bound "
          f"{fwd_bound['bound_ms']:.4f} ms ({fwd_bound['bound_by']}) on {fwd_bound['pairs']} "
          f"binned pairs; no library call; on {card}")

    # then H-bwd against its plain version, per pair and through the
    # scatter into the packed table
    args, caps = rec["args"], rec["kw"].get("caps", rec["args"][10] if len(rec["args"]) > 10
                                            else None)
    bwd_args = tuple(a.detach() if torch.is_tensor(a) else a for a in args[:10])
    print(f"  {label}: {bwd_args[0].shape[0] // 2} gaussians per view (padding included), "
          f"{int(bwd_args[2][-1])} binned (tile, gaussian) pairs, "
          f"{int(bwd_args[7].amax(1).max())} deepest contributor")
    out_k = blend_tiles_bwd(*bwd_args, caps=caps)
    out_p = blend_tiles_bwd_plain(*bwd_args, caps=caps)
    err = _bwd_compare(f"{label}, per pair", out_k, out_p)
    n_rows = bwd_args[0].shape[0]
    _bwd_compare(f"{label}, packed table", scatter_pair_grads(out_k, bwd_args[1], n_rows)[:, :9],
                 scatter_pair_grads(out_p, bwd_args[1], n_rows)[:, :9])
    ms, plain_ms, bound = _time_bwd(label, bwd_args, caps, card)
    return max(fwd_res["color"], fwd_res["T"]), err, {
        "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms, "fwd_bound": fwd_bound,
        "bwd_ms": ms, "bwd_plain_ms": plain_ms, "bwd_bound": bound}


def _train_rate(out, last):
    """Steady it/s between the logged steps 10 and `last` (metrics.jsonl)."""
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    steps = {r["step"]: r for r in records if "step" in r}
    return steps, (last - 10) / (steps[last]["t"] - steps[10]["t"])


def phase_train(device, card, work):
    """Stage-1 training at the canonical widths through the port's CLI."""
    import torch

    from gaussianavatar_torch import train as train_cli
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine.checkpoint import latest_epoch
    from gaussianavatar_torch.utils.cuda_build import LAUNCHES

    data, out = os.path.join(work, "data"), os.path.join(work, "out")
    t0 = time.perf_counter()
    write_synthetic_dataset(data, n_train=8, n_test=4, image_size=512, device=device)
    print(f"  wrote 8 training and 4 test frames of 512x512 with the port's writer in "
          f"{time.perf_counter() - t0:.1f} s")

    argv = _train_argv(data, out) + ["--max_steps", str(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    with _KernelRecorder() as recorder:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        t0 = time.perf_counter()
        train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  kernel launches in the training run: {counts} ({TRAIN_STEPS} steps)")
    for name in TRAIN_KERNELS:
        if counts[name] != TRAIN_STEPS:
            _fail(f"the training run launched {name} {counts[name]} times, not once per step")

    steps, rate = _train_rate(out, TRAIN_STEPS)
    first, last = steps[1]["total"], steps[TRAIN_STEPS]["total"]
    print(f"  training: {rate:.2f} it/s steady state (steps 10-{TRAIN_STEPS}), loss "
          f"{first:.5f} at step 1 -> {last:.5f} at step {TRAIN_STEPS}, peak memory "
          f"{peak_gb:.2f} GiB, raster overflow {steps[TRAIN_STEPS]['raster_overflow']:.0f} "
          f"pairs, {wall:.1f} s in all (setup included), on {card}")
    if not all(math.isfinite(r["total"]) for r in steps.values()) or not last < first:
        _fail("training loss not finite or not falling")
    if latest_epoch(out) is None:
        _fail("no checkpoint after training")

    # the last step's own batch: both kernels against their plain versions, timed
    fwd_err, err, t = _hold_train_batch(recorder.rec, card, "train batch")
    stats = {"rate": rate, "peak_gb": peak_gb}
    return fwd_err, stats, {
        "name": "blend_bwd", "route": "cuda",
        "source": "gaussianavatar_torch/csrc/blend_bwd.cu",
        "replaces": "gaussianavatar_tpu/ops/rasterize_ragged.py:405",
        "launches": counts["blend_bwd"],
        "max_abs_err": err,
        "ms": t["bwd_ms"], "plain_ms": t["bwd_plain_ms"],
        "bound_ms": t["bwd_bound"]["bound_ms"], "bound_by": t["bwd_bound"]["bound_by"],
        "library_ms": None,
    }, counts


def phase_stage2(device, card, work):
    """Stage 2 at the canonical widths on phase 5/6's output, through the
    users' entry points, each with the launch counts read around it: the
    export of the stage-1 poses, the per-frame posmaps at 128, 30 steps of
    `train --train_stage 2` (both kernels once per step, then held against
    their plain versions on the last step's batch), eval of the 4 test
    frames (one H-fwd launch) and 4 orbit frames of novel view (one)."""
    import torch

    from gaussianavatar_torch import (
        eval as eval_cli, export_stage_1, gen_pose_map_frames, render_novel_view,
        train as train_cli,
    )
    from gaussianavatar_torch.engine import checkpoint as ckpt

    data, out1 = os.path.join(work, "data"), os.path.join(work, "out")
    out = os.path.join(work, "out_stage2")
    stage1 = ckpt.ckpt_dir(out1, ckpt.latest_epoch(out1, ckpt.TRAIN_NAME))
    t0 = time.perf_counter()
    export_stage_1.main(["-m", out1, "-s", data])
    gen_pose_map_frames.main(["--source_path", data, "--synthetic", "--size", "128"])
    print(f"  export and 12 posmaps of 128x128 in {time.perf_counter() - t0:.1f} s "
          f"(stage 1: {os.path.relpath(stage1, work)})")

    argv = ["-s", data, "-m", out, "--train_stage", "2", "--stage1_out_path", stage1,
            "--dataset_type", "synthetic", "--no_lpips", "--max_steps", str(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    with _KernelRecorder() as recorder:
        _, counts, wall = _run_counted(train_cli.main, argv)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  kernel launches in the stage-2 training run: {counts} ({TRAIN_STEPS} steps)")
    for name in TRAIN_KERNELS:
        if counts[name] != TRAIN_STEPS:
            _fail(f"the stage-2 run launched {name} {counts[name]} times, not once per step")
    steps, rate = _train_rate(out, TRAIN_STEPS)
    last = steps[TRAIN_STEPS]
    print(f"  stage-2 training: {rate:.2f} it/s steady state (steps 10-{TRAIN_STEPS}), loss "
          f"{steps[1]['total']:.5f} at step 1 -> {last['total']:.5f} at step {TRAIN_STEPS}, "
          f"pose_loss {last['pose']:.6f}, peak memory {peak_gb:.2f} GiB, raster overflow "
          f"{last['raster_overflow']:.0f} pairs, {wall:.1f} s in all (setup included), on {card}")
    if not all(math.isfinite(r["total"]) and math.isfinite(r["pose"]) for r in steps.values()) \
            or not last["pose"] > 0:
        _fail("stage-2 loss or pose_loss not finite, or no pose feature map")
    saved = torch.load(os.path.join(ckpt.ckpt_dir(out, ckpt.latest_epoch(out, ckpt.TRAIN_NAME)),
                                    ckpt.TRAIN_NAME), weights_only=True)
    if saved["iteration"] != TRAIN_STEPS or set(saved["optimizer"]) != {"net", "pose_enc"}:
        _fail("the stage-2 save does not hold its iteration and the stage-2 optimizer groups")
    fwd_err, bwd_err, t = _hold_train_batch(recorder.rec, card, "stage-2 train batch")

    result, eval_counts, wall = _run_counted(eval_cli.main, ["-m", out])
    print(f"  stage-2 eval: {result['frames']} test frames of 512x512, PSNR {result['psnr']:.3f} "
          f"SSIM {result['ssim']:.5f}, {result['frames'] / result['render_s']:.2f} frames/s in "
          f"the render calls ({wall:.1f} s in all, setup included), launches {eval_counts}, "
          f"on {card}")
    n_batches = -(-result["frames"] // eval_cli.EVAL_B)
    if not all(math.isfinite(result[k]) for k in ("psnr", "ssim")):
        _fail("stage-2 eval wrote no finite PSNR / SSIM")
    if eval_counts["blend_fwd"] != n_batches or eval_counts["blend_bwd"] != 0:
        _fail(f"stage-2 eval launched {eval_counts}, not H-fwd once per {eval_cli.EVAL_B} frames")

    _, view_counts, wall = _run_counted(render_novel_view.main, ["-m", out, "--frames", "4"])
    pngs = sorted(os.listdir(os.path.join(out, "novel_view", "pose_0")))
    print(f"  stage-2 novel view: {pngs} in {wall:.1f} s, launches {view_counts}")
    if pngs != [f"{i:05d}.png" for i in range(4)] or view_counts["blend_fwd"] != 1:
        _fail("the stage-2 novel view did not write 4 frames through one H-fwd launch")
    total = {name: counts[name] + eval_counts[name] + view_counts[name] for name in counts}
    return fwd_err, bwd_err, total


# LPIPS on the card against LPIPS on the CPU, on the same two images and
# weights: the distance within this share of itself, the input gradient
# within this share of its largest |value| (cuDNN and the CPU's convolutions
# sum in other orders; TF32 is off)
TOL_LPIPS_REL = 1e-4
TOL_LPIPS_GRAD = 1e-3
# the overlay's body: the campaign's synthetic body (scripts/torch_quality_gate.py)
OVERLAY_BODY = {"n_rings": 48, "n_cols": 32}


def _lpips_on_card_vs_cpu(proj, data, card):
    """LPIPS from the project's weights, on the card and on the CPU, on two
    training frames against two others (B=2 of 512^2 in [-1, 1]): the
    distance and its gradient with respect to the first pair; then the
    card's forward + backward and forward alone timed (CUDA events)."""
    import numpy as np
    import torch
    from PIL import Image

    from gaussianavatar_torch.ops.lpips import try_load_lpips

    frames = [np.asarray(Image.open(os.path.join(data, "train", "images", f"{i:08d}.png")),
                         np.float32).transpose(2, 0, 1) / 127.5 - 1 for i in range(4)]
    a, b = torch.tensor(np.stack(frames[:2])), torch.tensor(np.stack(frames[2:]))
    out = {}
    for dev in ("cuda", "cpu"):
        fn = try_load_lpips(proj, device=dev)
        x = a.to(dev).requires_grad_(True)
        val = fn(x, b.to(dev))
        (grad,) = torch.autograd.grad(val, x)
        out[dev] = (float(val.detach()), grad.cpu())
    (v_k, g_k), (v_c, g_c) = out["cuda"], out["cpu"]
    rel = abs(v_k - v_c) / abs(v_c)
    g_err = float((g_k - g_c).abs().max() / g_c.abs().max())
    print(f"  LPIPS on the card vs the CPU (B=2 of 512x512): distance {v_k:.7f} vs {v_c:.7f}, "
          f"rel {rel:.2e} (tol {TOL_LPIPS_REL:g}); input gradient max|d| / max|grad| "
          f"{g_err:.2e} (tol {TOL_LPIPS_GRAD:g})")
    if not (math.isfinite(v_k) and v_c > 0) or rel > TOL_LPIPS_REL or g_err > TOL_LPIPS_GRAD:
        _fail("LPIPS on the card disagrees with LPIPS on the CPU")
    fn = try_load_lpips(proj, device="cuda")
    x, y = a.cuda().requires_grad_(True), b.cuda()
    ms = _time_ms(lambda: torch.autograd.grad(fn(x, y), x), reps=20)
    fwd_ms = _time_ms(lambda: fn(x, y), reps=20)
    print(f"  LPIPS (4 AlexNet forwards, the backward to the first pair) at B=2 of 512x512: "
          f"{ms:.3f} ms forward + backward, {fwd_ms:.3f} ms forward (CUDA events), on {card}")


def _romp_capture(data, romp):
    """A ROMP / InstantAvatar capture of the dataset's 12 frames (train, then
    test): images/ and masks/ as frame_NNNN.png, cameras.npz,
    poses_optimized.npz. -> the capture's full poses (12, 72)."""
    import shutil

    import numpy as np

    from gaussianavatar_torch.data.dataset import load_smpl_parms

    os.makedirs(os.path.join(romp, "images"))
    os.makedirs(os.path.join(romp, "masks"))
    poses, transl, k = [], [], 0
    for split in ("train", "test"):
        d = os.path.join(data, split)
        parms = load_smpl_parms(os.path.join(d, "smpl_parms.pth"))
        for i, name in enumerate(sorted(os.listdir(os.path.join(d, "images")))):
            for kind in ("images", "masks"):
                shutil.copy(os.path.join(d, kind, name),
                            os.path.join(romp, kind, f"frame_{k:04d}.png"))
            poses.append(parms["body_pose"][i])
            transl.append(parms["trans"][i])
            k += 1
        with np.load(os.path.join(d, "cam_parms.npz")) as cam:
            np.savez(os.path.join(romp, "cameras.npz"), intrinsic=cam["intrinsic"],
                     extrinsic=cam["extrinsic"])
    poses = np.stack(poses).astype(np.float32)
    np.savez(os.path.join(romp, "poses_optimized.npz"), global_orient=poses[:, :3],
             body_pose=poses[:, 3:], transl=np.stack(transl).astype(np.float32),
             betas=np.asarray(parms["beta"], np.float32).reshape(-1))
    return poses


def phase_pipeline(device, card, work, train_stats):
    """Phase 8 on phase 5's data and checkpoint: LPIPS training and eval,
    the PLY export, subject preprocessing and the SMPL overlay, through the
    users' entry points. -> (H-fwd's error, H-bwd's error, launches)."""
    import numpy as np
    import torch

    from gaussianavatar_torch import (
        eval as eval_cli, export_avatar_ply, gen_pose_map_cano, render_pred_smpl,
        sample_romp2gsavatar, train as train_cli,
    )
    from gaussianavatar_torch.config import Config
    from gaussianavatar_torch.data.dataset import MonoDatasetTrain, load_smpl_parms
    from gaussianavatar_torch.engine import inference
    from gaussianavatar_torch.engine.export import load_gaussians_ply
    from gaussianavatar_torch.ops.lpips import random_lpips_weights
    from gaussianavatar_torch.ops.rasterize_tile import blend_tiles, blend_tiles_plain

    data, out1 = os.path.join(work, "data"), os.path.join(work, "out")

    # (a) LPIPS training and eval
    proj, out = os.path.join(work, "lpips_proj"), os.path.join(work, "out_lpips")
    os.makedirs(os.path.join(proj, "assets", "lpips"))
    np.savez(os.path.join(proj, "assets", "lpips", "lpips_alex.npz"), **random_lpips_weights(0))
    argv = [a for a in _train_argv(data, out) if a != "--no_lpips"] + [
        "--lpips_start_iter", "0", "--project_path", proj, "--max_steps", str(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    with _KernelRecorder() as recorder:
        _, counts, wall = _run_counted(train_cli.main, argv)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  kernel launches in the LPIPS training run: {counts} ({TRAIN_STEPS} steps)")
    for name in TRAIN_KERNELS:
        if counts[name] != TRAIN_STEPS:
            _fail(f"the LPIPS run launched {name} {counts[name]} times, not once per step")
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    events = {r["event"]: r["value"] for r in records if "event" in r}
    steps, rate = _train_rate(out, TRAIN_STEPS)
    if events.get("lpips") != "active":
        _fail(f"the LPIPS run's lpips event is {events.get('lpips')!r}, not 'active'")
    if not all("vgg" in r and math.isfinite(r["vgg"]) and math.isfinite(r["total"])
               for r in steps.values()):
        _fail("the LPIPS run logged a step without a finite vgg term")
    last = steps[TRAIN_STEPS]
    print(f"  LPIPS training: {rate:.2f} it/s steady (steps 10-{TRAIN_STEPS}; phase 5 "
          f"{train_stats['rate']:.2f}), peak memory {peak_gb:.2f} GiB (phase 5 "
          f"{train_stats['peak_gb']:.2f}), loss {steps[1]['total']:.5f} at step 1 -> "
          f"{last['total']:.5f} at step {TRAIN_STEPS}, vgg {steps[1]['vgg']:.5f} -> "
          f"{last['vgg']:.5f}, {wall:.1f} s in all (setup included), on {card}")
    fwd_err, bwd_err, _ = _hold_train_batch(recorder.rec, card, "LPIPS train batch")
    _lpips_on_card_vs_cpu(proj, data, card)
    result, eval_counts, wall = _run_counted(eval_cli.main, ["-m", out])
    lp = result["lpips"]
    print(f"  LPIPS eval: {result['frames']} test frames, PSNR {result['psnr']:.3f}, SSIM "
          f"{result['ssim']:.5f}, LPIPS {lp} (random weights), launches {eval_counts}, "
          f"{wall:.1f} s in all")
    report = open(os.path.join(out, "test_free", "results.txt")).read()
    if lp is None or not math.isfinite(lp) or f"lpips: {lp:.6f}\n" not in report \
            or len(result["frame_lpips"]) != result["frames"]:
        _fail("eval with LPIPS weights wrote no numeric lpips line")
    if eval_counts["blend_fwd"] != -(-result["frames"] // eval_cli.EVAL_B):
        _fail(f"the LPIPS eval launched {eval_counts}")

    # (d) the PLY export of phase 5's checkpoint at frame 0, against the
    # gaussians the renderer draws for that frame
    ply = os.path.join(work, "avatar_frame0.ply")
    _, exp_counts, exp_s = _run_counted(export_avatar_ply.main,
                                        ["-m", out1, "--frame", "0", "--out", ply])
    back = load_gaussians_ply(ply)
    cfg = Config.load(os.path.join(out1, "cfg_args.json"))
    inf = inference.load_trained(cfg, device=device)
    nv = inf.bundle.assets.num_valid
    item = MonoDatasetTrain(cfg.model)[0]
    batch = inference.batch_from_item(item)
    drawn = {}
    real = inference.rasterize_views

    def recording(*a, **kw):
        drawn["args"] = a
        return real(*a, **kw)

    inference.rasterize_views = recording
    try:
        inference.make_renderer(inf, int(item["height"]), int(item["width"]))(batch)
    finally:
        inference.rasterize_views = real
    means, colors, scales3, rots, opac = (x.cpu().numpy() for x in drawn["args"][:5])
    errs = {
        "means": float(np.abs(back["means"] - means[0, :nv]).max()),
        "colors": float(np.abs(back["colors"] - colors[0, :nv]).max()),
        "scales": float(np.abs(back["scales"] / scales3[0, :nv] - 1).max()),
        "opacities": float(np.abs(back["opacities"]
                                  - np.clip(opac[:nv], 1e-4, 1 - 1e-4)).max()),
        "rotations": float(np.abs(back["rotations"] - rots[:nv]).max()),
    }
    tols = {"means": 1e-6, "colors": 1e-6, "scales": 1e-6, "opacities": 1e-6, "rotations": 0.0}
    print(f"  export: {len(back['means'])} gaussians (num_valid {nv}) in {exp_s:.2f} s, "
          f"launches {exp_counts}; PLY vs the render's gaussians: " + ", ".join(
              f"{k} {v:.2e} (tol {tols[k]:g})" for k, v in errs.items()))
    if len(back["means"]) != nv or any(errs[k] > tols[k] for k in errs):
        _fail("the exported PLY does not hold the gaussians the renderer draws")

    # (b) preprocessing: the canonical files, then a ROMP capture
    prep = os.path.join(work, "prep_proj")
    t0 = time.perf_counter()
    gen_pose_map_cano.main(["--source_path", data, "--synthetic", "--sizes", "512", "128",
                            "--project_path", prep])
    cano_s = time.perf_counter() - t0
    valid = {R: int((np.load(os.path.join(prep, "assets", "uv_masks",
                                          f"uv_mask{R}_with_faceid_smpl.npy")) >= 0).sum())
             for R in (512, 128)}
    with np.load(os.path.join(data, "train", "query_posemap_512_cano_smpl.npz")) as f:
        posmap_valid = int((f["posmap512"] != 0).any(-1).sum())
    print(f"  gen_pose_map_cano: {cano_s:.2f} s, valid uv pixels {valid}, posmap 512 "
          f"non-zero pixels {posmap_valid}; phase 5 trained {nv} gaussians")
    if valid[512] != nv:
        _fail("the canonical posmap's valid pixels are not phase 5's gaussians")
    romp, conv = os.path.join(work, "romp"), os.path.join(work, "data_romp")
    poses = _romp_capture(data, romp)
    t0 = time.perf_counter()
    sample_romp2gsavatar.main(["--input", romp, "--output", conv])
    romp_s = time.perf_counter() - t0
    split = {s: sorted(os.listdir(os.path.join(conv, s, "images"))) for s in ("train", "test")}
    ok = split["train"] == [f"{i:08d}.png" for i in range(9)] \
        and split["test"] == [f"{i:08d}.png" for i in range(3)]
    for s, ids in (("train", range(9)), ("test", range(9, 12))):
        parms = load_smpl_parms(os.path.join(conv, s, "smpl_parms.pth"))
        ok &= np.array_equal(parms["body_pose"], poses[list(ids)])
        ok &= sorted(os.listdir(os.path.join(conv, s, "masks"))) == split[s]
        ok &= os.path.exists(os.path.join(conv, s, "cam_parms.npz"))
    print(f"  sample_romp2gsavatar: 12 frames -> train {len(split['train'])}, test "
          f"{len(split['test'])} in {romp_s:.2f} s")
    if not ok:
        _fail("sample_romp2gsavatar did not write the 80/20 tree with the capture's poses")

    # (c) the SMPL overlay: 8 frames of 512^2, one H-fwd launch each
    qa = os.path.join(work, "qa_overlay")
    n_frames = 8
    with _KernelRecorder() as recorder:
        _, ov_counts, ov_s = _run_counted(
            lambda: render_pred_smpl.main(["--source_path", data, "--synthetic", "--n_frames",
                                           str(n_frames), "--out", qa], body_kwargs=OVERLAY_BODY))
    pngs = sorted(os.listdir(qa))
    print(f"  overlay: {len(pngs)} frames of 512x512 with the {OVERLAY_BODY} body in "
          f"{ov_s:.2f} s ({n_frames / ov_s:.2f} frames/s, setup and PNG writes included), "
          f"launches {ov_counts}, on {card}")
    if pngs != [f"{i:05d}.png" for i in range(n_frames)] or ov_counts["blend_fwd"] != n_frames \
            or ov_counts["blend_bwd"]:
        _fail("the overlay did not write its frames through one H-fwd launch each")
    rec = recorder.rec
    args = tuple(a.detach() if torch.is_tensor(a) else a for a in rec["fwd_args"][:6])
    caps = rec["fwd_kw"].get("caps")
    ov_res = _compare(blend_tiles(*args, caps=caps), blend_tiles_plain(*args, caps=caps))
    _check_blend("overlay frame, H-fwd", ov_res)

    total = {name: counts[name] + eval_counts[name] + exp_counts[name] + ov_counts[name]
             for name in counts}
    return max(fwd_err, ov_res["color"], ov_res["T"]), bwd_err, total


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "gaussianavatar_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(gaussianavatar_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    device = "cuda"
    t_all = time.perf_counter()
    print("phase 1: setup")
    card = phase_setup()
    print("phase 2: H-fwd vs plain, random scene at the render shapes")
    phase_random_scene(device)
    print("phase 3: stage-1 novel-pose render, canonical widths")
    fwd = phase_slice(device, card)
    print("phase 4: H-bwd vs plain, random scene at the render shapes")
    phase_bwd_random_scene(device, card)
    print("phase 5: stage-1 training, canonical widths")
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        train_fwd_err, train_stats, bwd, train_counts = phase_train(device, card, work)
        print("phase 6: resume, eval and novel view on phase 5's output")
        rest_counts = phase_rest_of_path(card, work)
        print("phase 7: stage 2 on phase 6's output: export, posmaps, training, eval, novel view")
        s2_fwd_err, s2_bwd_err, s2_counts = phase_stage2(device, card, work)
        print("phase 8: the rest of the pipeline on phase 5's data: LPIPS training and eval, "
              "preprocessing, the SMPL overlay, the PLY export")
        p8_fwd_err, p8_bwd_err, p8_counts = phase_pipeline(device, card, work, train_stats)
    # launches: each main path's run, added (the render's H-fwd, training's,
    # then the resumed run's, eval's and the novel view's, then stage 2's,
    # then phase 8's)
    fwd["launches"] += (train_counts["blend_fwd"] + rest_counts["blend_fwd"]
                        + s2_counts["blend_fwd"] + p8_counts["blend_fwd"])
    bwd["launches"] += rest_counts["blend_bwd"] + s2_counts["blend_bwd"] + p8_counts["blend_bwd"]
    fwd["max_abs_err"] = max(fwd["max_abs_err"], train_fwd_err, s2_fwd_err, p8_fwd_err)
    bwd["max_abs_err"] = max(bwd["max_abs_err"], s2_bwd_err, p8_bwd_err)
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [fwd, bwd]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
