#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gaussianavatar_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits nonzero otherwise):
  1. setup: the card's name and power limit, torch / CUDA / nvcc versions,
     and the build of every CUDA kernel of the port from csrc/ (timed, one
     nvcc per source, all at once);
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
     and held against the gaussians the renderer draws for that frame;
  9. the rest of single-subject training on phase 5's data, through the
     users' entry points, the launch counts read around each: (a) 30
     stage-1 steps with `--use_aiap --pos_encoding 1` (aiap finite at every
     logged step, the decoder 88 inputs wide, H-fwd and H-bwd once per step
     and held against their plain versions on the last batch, it/s and
     peak memory beside phase 5's), then `grid_knn` over the 222,784 valid
     query points on the card against `host_knn` (both timed; neighbour
     sets and distances where the cell contract holds); (b) one 1024^2
     view of 20,000 gaussians at SH degree 3 through `ops/rasterize.
     rasterize` (H-fwd once, held against the plain blend; H-bwd once; the
     coefficients' gradient against the CPU's plain path); (c) 5 steps
     with `--profile_dir` (the Chrome trace names train::step and both
     kernels at every step); (d) the pose-recovery leg of
     scripts/torch_quality_gate.py on phase 6's save for 2 epochs (its
     record's keys, exact launch counts, both kernels held on its last
     batch; the gate's numbers printed, not enforced);
 10. the scale-out entry points, the launch counts read around each:
     (a) `python -m gaussianavatar_torch.train_multi` (its `main`) on 4
     subjects of 512^2 from the port's writer (8, 8, 6 and 6 training
     frames, 4 test frames each) at phase 5's widths, 20 steps (H-fwd and
     H-bwd once per subject per step), the per-subject saves, metrics and
     log PNGs, both kernels held against their plain versions on the last
     step's batch, it/s x 4, subject-steps/s and peak memory beside phase
     5's; the 4 subjects resumed for one epoch (3 steps: iteration and
     optimizer counts go on); `eval` of a 6-frame subject (one H-fwd
     launch); (b) `python -m gaussianavatar_torch.train --dp 2` on phase
     5's data, two ranks on the one card over gloo, 10 steps against two
     `--dp 1` runs from the same seed, and stage 2 from phase 7's
     stage-1 save for 3 steps at the f32 and the bf16 decoder, where the
     BatchNorm sync shows: the first step's loss and stage 1's 10-step
     trajectory (at the f32 decoder) within the limits by TOL_DP_FIRST,
     each exceeded by a control run whose ranks break one piece of the
     step (RANK_FAULTS); in stage 2 the control is read on the saved
     BatchNorm running statistics (TOL_DP_BN);
     rank 0's last H-fwd and H-bwd inputs in each sound run held against
     the plain versions; the ranks' launches summed from metrics.jsonl,
     exact. Two ranks that share one card measure what the sharing
     costs, not scaling;
 11. the fused POP decoder (`--fused_decoder 1`), the launch counts read
     around each entry point: (a) its three kernels, H-dstat
     (csrc/decoder_stats.cu), H-dfwd (csrc/decoder_stage_fwd.cu) and H-dbwd
     (csrc/decoder_stage_bwd.cu), against their plain versions on random
     inputs at the canonical stage shapes (445,568 rows; 66 float32, 128
     and 194 bfloat16 inputs, and the float32 decoder's 128) and at the
     other widths the JAX decoder takes (hsize 64, 96, 256; an odd
     c_geom), each timed beside its bound and its library yardstick; (b)
     `train --fused_decoder 1` on phase 5's data, 30 steps (it/s and peak
     memory beside phase 5's), 10 at the float32 decoder, 3 stage-2 steps
     from phase 7's stage-1 save, and 5 steps each at --hsize 96
     --c_geom 63 and at --hsize 256, launches exact (9 H-dstat, 11 H-dfwd
     and 11 H-dbwd per training decode, 11 H-dfwd per eval-mode decode),
     each run's last decoder inputs held against the plain versions; (c)
     phase 5's reference checkpoint through both decoders (eval,
     render_novel_pose)
     and (b)'s fused one through the reference decoder, all at the float32
     decoder, each reading
     within a limit that a control (one BatchNorm's running variance x
     1.5) exceeds; (d) `--dp 2` against `--dp 1` in stage 2 at the float32
     fused decoder, its first step's loss and its saved BatchNorm running
     statistics, against ranks whose decoder skips its statistics
     all-reduce; (e) train_multi, render_novel_view and export_avatar_ply
     through the fused decoder;
 12. `--steps_per_dispatch` (engine/train_step.make_train_steps) on the
     campaign's data layout (48 frames of 512^2 from the port's writer, 24
     batches an epoch), each run through the training CLI at 8 steps a
     dispatch (a CUDA graph of 8 steps captured after the first group ran
     eagerly, then replayed) and at 1, from one seed, beside a control
     whose replay keeps one group's static batch buffers stale: (a) stage
     1 at the canonical widths, 48 steps (6 groups), with the reference
     and the fused decoder (a second S=1 run prints the atomics' spread),
     the graph-replayed batch's H-fwd and H-bwd held against their plain
     versions, and H-bwd with the scatter over the whole slot table (what
     the graph needs) against the binned prefix, timed, peak memory;
     (b) stage 2 on (a)'s save, 24 steps; (c) LPIPS (random weights of the
     exact layout) joining at epoch 2 with AIAP on: the gate flips and a
     second graph is captured; (d) (a)-(c) again under torch's
     deterministic algorithms, where S=8 and S=1 give every step's loss and
     the whole final state bit for bit and each control does not. (a) and
     (b) hold the loss over the first two groups within limits their
     controls exceed (the atomics of `index_add_` part even two S=1 runs);
     launches exact (once a step, the fused decoder 9 / 11 / 11 per
     training decode), the graphs captured and replayed counted; it/s over
     groups 3-6, capture seconds, peak memory.
It prints one JSON line of per-kernel numbers, then, last,
{"ok": true, "device": {...}}. It needs CUDA and the repository around it.
"""

import contextlib
import json
import math
import os
import re
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


def make_slice(device, decoder_impl="ref"):
    """The main path's setup: a synthetic avatar at the canonical widths
    (query posmap 512, input posmap 128, c_geom 64, hsize 128, bf16 decoder,
    the reference or the fused one, random weights from seed 0), its
    stage-1 renderer from `make_renderer`,
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
        decoder_impl=decoder_impl,
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
    # the first group of the resumed run ends with epoch 9, 4 steps on
    if first["step"] != TRAIN_STEPS + 4 or end["iteration"] != TRAIN_STEPS + resumed_steps \
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
    """While active, the blend wrappers keep their last call's inputs,
    detached (they launch as before; a kept autograd graph would keep its
    AccumulateGrad nodes, and their streams, alive into the next step)."""

    def __enter__(self):
        import torch

        from gaussianavatar_torch.ops import rasterize_tile

        self.mod = rasterize_tile
        self.real_fwd, self.real_bwd = rasterize_tile.blend_tiles, rasterize_tile.blend_tiles_bwd
        self.rec = {}

        detach = lambda a: tuple(x.detach() if torch.is_tensor(x) else x for x in a)

        def fwd(*a, **kw):
            self.rec["fwd_args"], self.rec["fwd_kw"] = detach(a), kw
            return self.real_fwd(*a, **kw)

        def bwd(*a, **kw):
            self.rec["args"], self.rec["kw"] = detach(a), kw
            return self.real_bwd(*a, **kw)

        rasterize_tile.blend_tiles, rasterize_tile.blend_tiles_bwd = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.mod.blend_tiles, self.mod.blend_tiles_bwd = self.real_fwd, self.real_bwd


def _bwd_inputs(rec):
    """H-bwd's recorded inputs (detached) and caps."""
    import torch

    args = rec["args"]
    caps = rec["kw"].get("caps", args[10] if len(args) > 10 else None)
    return tuple(a.detach() if torch.is_tensor(a) else a for a in args[:10]), caps


def _hold_train_batch(rec, card, label, timed=True):
    """H-fwd and H-bwd against their plain versions on the inputs a training
    step gave them (`rec` from _KernelRecorder), each timed beside its
    bound unless `timed` is False. -> (H-fwd's error, H-bwd's error,
    {fwd_ms, fwd_plain_ms, fwd_bound, bwd_ms, bwd_plain_ms, bwd_bound} or
    None)."""
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
    if not timed:
        bwd_args, caps = _bwd_inputs(rec)
        out_k = blend_tiles_bwd(*bwd_args, caps=caps)
        err = _bwd_compare(f"{label}, H-bwd per pair", out_k,
                           blend_tiles_bwd_plain(*bwd_args, caps=caps))
        return max(fwd_res["color"], fwd_res["T"]), err, None
    fwd_ms = _time_ms(lambda: blend_tiles(*fwd_args, caps=fwd_caps), reps=20)
    fwd_plain_ms = _time_ms(lambda: blend_tiles_plain(*fwd_args, caps=fwd_caps), reps=3, warmup=1)
    fwd_bound = _blend_bound(fwd_args, fwd_caps)
    _print_walk(f"{label} (H-fwd walk)", fwd_bound)
    print(f"  {label}: H-fwd {fwd_ms:.4f} ms, plain {fwd_plain_ms:.3f} ms, bound "
          f"{fwd_bound['bound_ms']:.4f} ms ({fwd_bound['bound_by']}) on {fwd_bound['pairs']} "
          f"binned pairs; no library call; on {card}")

    # then H-bwd against its plain version, per pair and through the
    # scatter into the packed table
    bwd_args, caps = _bwd_inputs(rec)
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
    """Steady it/s between the first logged step from 10 on and `last`
    (metrics.jsonl; the loop logs as the JAX loop does at 8 steps a
    dispatch: on 4-batch epochs after steps 4, 8, 12, 16, 20, 24 and 30)
    -> (logged steps, it/s, the first step of the span)."""
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    steps = {r["step"]: r for r in records if "step" in r}
    s0 = min(s for s in steps if s >= 10)
    return steps, (last - s0) / (steps[last]["t"] - steps[s0]["t"]), s0


def _dumps(steps, per_epoch=4, spd=8, log_iter=2000):
    """The debug dumps (one eval-mode decode each) of a `steps`-step run
    from the start, on `per_epoch` batches an epoch with fewer than `spd`
    (8) of them: every group ends at an epoch's end or at `steps`, and the
    JAX loop's rule dumps after a group whose end minus one lies within
    `spd` past a multiple of `log_iter`."""
    ends = sorted(set(range(per_epoch, steps, per_epoch)) | {steps})
    return sum((e - 1) % log_iter < spd for e in ends)


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

    steps, rate, s0 = _train_rate(out, TRAIN_STEPS)
    first, last = steps[min(steps)]["total"], steps[TRAIN_STEPS]["total"]
    print(f"  training: {rate:.2f} it/s steady state (steps {s0}-{TRAIN_STEPS}), loss "
          f"{first:.5f} at step {min(steps)} -> {last:.5f} at step {TRAIN_STEPS}, peak memory "
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
    steps, rate, s0 = _train_rate(out, TRAIN_STEPS)
    last = steps[TRAIN_STEPS]
    print(f"  stage-2 training: {rate:.2f} it/s steady state (steps {s0}-{TRAIN_STEPS}), loss "
          f"{steps[min(steps)]['total']:.5f} at step {min(steps)} -> {last['total']:.5f} at step "
          f"{TRAIN_STEPS}, "
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
    steps, rate, s0 = _train_rate(out, TRAIN_STEPS)
    if events.get("lpips") != "active":
        _fail(f"the LPIPS run's lpips event is {events.get('lpips')!r}, not 'active'")
    if not all("vgg" in r and math.isfinite(r["vgg"]) and math.isfinite(r["total"])
               for r in steps.values()):
        _fail("the LPIPS run logged a step without a finite vgg term")
    last = steps[TRAIN_STEPS]
    print(f"  LPIPS training: {rate:.2f} it/s steady (steps {s0}-{TRAIN_STEPS}; phase 5 "
          f"{train_stats['rate']:.2f}), peak memory {peak_gb:.2f} GiB (phase 5 "
          f"{train_stats['peak_gb']:.2f}), loss {steps[min(steps)]['total']:.5f} at step "
          f"{min(steps)} -> {last['total']:.5f} at step {TRAIN_STEPS}, vgg "
          f"{steps[min(steps)]['vgg']:.5f} -> "
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


# grid_knn over phase 5's query points: cells of 5 mm (the points' 5th
# neighbour lies within 4.02 mm of each), at most 16 points a cell
KNN_K, KNN_CELL, KNN_PER_CELL = 5, 0.005, 16
# the SH render: a random scene of gaussians in front of phase 3's camera,
# its coefficients' gradient on the card against the CPU's plain path within
# this share of the largest |gradient| (projection and binning run on both,
# rounding differently; a gate flip at alpha 1/255 moves one pixel's term)
SH_N, SH_DEG, TOL_SH_GRAD_REL = 20_000, 3, 1e-3
# the pose-recovery record's keys (scripts/quality_gate.py's leg)
POSE_KEYS = {"init_err", "refined_err", "steps", "loss_floor", "loss_first_epoch",
             "loss_last_epoch", "recovered_fraction", "render_psnr_perturbed",
             "render_psnr_refined", "pass"}


def _knn_check(points, card):
    """grid_knn on the card against host_knn over the same points; both
    timed. Fails where the cell contract holds and the two disagree."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from gaussianavatar_torch.ops.knn import grid_knn, host_knn

    pts = points.cpu().numpy()
    t0 = time.perf_counter()
    host_idx = host_knn(pts, KNN_K)
    host_s = time.perf_counter() - t0
    ms = _time_ms(lambda: grid_knn(points, KNN_K, KNN_CELL, KNN_PER_CELL), reps=3, warmup=1)
    idx, dist = (x.cpu().numpy() for x in grid_knn(points, KNN_K, KNN_CELL, KNN_PER_CELL))
    d_exact, _ = cKDTree(pts).query(pts, k=KNN_K + 2)
    cells = np.floor(pts / KNN_CELL).astype(np.int64)
    per_cell = int(np.unique(cells, axis=0, return_counts=True)[1].max())
    held = d_exact[:, KNN_K] <= KNN_CELL          # the k-th neighbour within one cell
    if per_cell > KNN_PER_CELL or held.mean() < 0.99:
        _fail(f"the cell contract does not hold: the fullest cell holds {per_cell} points "
              f"(at most {KNN_PER_CELL}), the k-th neighbour lies within a cell at "
              f"{held.mean() * 100:.2f}% of points")
    # neighbour sets decide only where the k-th and (k+1)-th do not tie
    untied = held & (d_exact[:, KNN_K + 1] - d_exact[:, KNN_K] > 1e-6)
    same_rows = float((idx == host_idx)[held].all(1).mean())
    same_sets = np.sort(idx, 1) == np.sort(host_idx, 1)
    sets_agree = float(same_sets[untied].all(1).mean())
    d_err = float(np.abs(dist - d_exact[:, 1:KNN_K + 1])[held].max())
    print(f"  grid_knn on {len(pts)} query points (k {KNN_K}, cell {KNN_CELL * 1e3:.0f} mm, "
          f"<= {KNN_PER_CELL} a cell; the fullest holds {per_cell}; contract held at "
          f"{held.mean() * 100:.2f}% of points): {ms:.3f} ms on the card, host_knn "
          f"{host_s * 1e3:.1f} ms on the host; rows equal at {same_rows * 100:.2f}%, "
          f"neighbour sets equal at {sets_agree * 100:.3f}% of the {int(untied.sum())} points "
          f"without a tie at the k-th, max|d dist| {d_err:.2e} (tol 1e-6); on {card}")
    if sets_agree < 1.0 or d_err > 1e-6:
        _fail("grid_knn disagrees with host_knn where the cell contract holds")
    return ms, host_s


def _sh_scene(device):
    """SH_N gaussians in the box the avatar stands in, coefficients of
    degree SH_DEG, phase 3's 1024^2 camera, all from seed 0."""
    import numpy as np
    import torch

    from gaussianavatar_torch.ops.camera import Camera

    g = torch.Generator().manual_seed(0)
    u = lambda *s: torch.rand(s, generator=g)
    means = (u(SH_N, 3) - 0.5) * torch.tensor([0.8, 1.6, 0.4]) + torch.tensor([0.0, 0.8, 0.0])
    q = torch.randn((SH_N, 4), generator=g)
    scene = {"means": means, "scales": 0.004 + 0.008 * u(SH_N, 3),
             "rotations": q / q.norm(dim=-1, keepdim=True), "opacities": 0.3 + 0.7 * u(SH_N),
             "shs": 0.3 * torch.randn((SH_N, (SH_DEG + 1) ** 2, 3), generator=g),
             "cot": torch.randn((3, 1024, 1024), generator=g)}
    K = np.array([[1120.0, 0, 512.0], [0, 1120.0, 512.0], [0, 0, 1]], np.float32)
    cam = Camera.from_extrinsics(np.eye(3, dtype=np.float32),
                                 np.array([0.0, -0.8, 1.6], np.float32), K, 1024, 1024,
                                 device=device)
    return {k: v.to(device) for k, v in scene.items()}, cam


def _sh_render(scene, cam):
    """rasterize with SH coefficients, then the backward of <image, cot>
    -> (image, the coefficients' gradient)."""
    import torch

    from gaussianavatar_torch.ops.rasterize import RasterizeConfig, rasterize

    shs = scene["shs"].clone().requires_grad_(True)
    img = rasterize(scene["means"], None, scene["scales"], scene["rotations"],
                    scene["opacities"], cam, torch.ones(3, device=shs.device),
                    config=RasterizeConfig(32, 4), shs=shs, sh_degree=SH_DEG)
    (img * scene["cot"]).sum().backward()
    return img.detach(), shs.grad


def phase_train_terms(device, card, work, train_stats):
    """Phase 9 on phase 5's data and checkpoint: (a) training with AIAP and
    the positional encoding, grid_knn on the card; (b) the SH render; (c)
    the profiled run; (d) the pose-recovery leg. -> (H-fwd's error, H-bwd's
    error, launches)."""
    import numpy as np
    import torch

    from gaussianavatar_torch import train as train_cli
    from gaussianavatar_torch.config import Config
    from gaussianavatar_torch.engine import checkpoint as ckpt
    from gaussianavatar_torch.engine.setup import setup_avatar
    from gaussianavatar_torch.ops.rasterize_tile import blend_tiles, blend_tiles_plain

    data, out1 = os.path.join(work, "data"), os.path.join(work, "out")
    errs_fwd, errs_bwd, total = [], [], {}

    def add(counts):
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    # (a) 30 steps with --use_aiap --pos_encoding 1
    t_phase = time.perf_counter()
    out = os.path.join(work, "out_terms")
    argv = _train_argv(data, out) + ["--use_aiap", "--pos_encoding", "1",
                                     "--max_steps", str(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    with _KernelRecorder() as recorder:
        _, counts, wall = _run_counted(train_cli.main, argv)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  kernel launches in the AIAP + positional-encoding run: {counts} "
          f"({TRAIN_STEPS} steps)")
    for name in TRAIN_KERNELS:
        if counts[name] != TRAIN_STEPS:
            _fail(f"the AIAP run launched {name} {counts[name]} times, not once per step")
    add(counts)
    steps, rate, s0 = _train_rate(out, TRAIN_STEPS)
    if not all("aiap" in r and math.isfinite(r["aiap"]) and math.isfinite(r["total"])
               for r in steps.values()):
        _fail("the AIAP run logged a step without a finite aiap term")
    last = steps[TRAIN_STEPS]
    sd = torch.load(os.path.join(ckpt.ckpt_dir(out, ckpt.latest_epoch(out)), ckpt.CKPT_NAME),
                    weights_only=True)
    width = sd["pop.decoder.dense.0.weight"].shape[1]
    first = steps[min(steps)]
    print(f"  AIAP + positional encoding: {rate:.2f} it/s steady (steps {s0}-{TRAIN_STEPS}; "
          f"phase 5 {train_stats['rate']:.2f}), peak memory {peak_gb:.2f} GiB (phase 5 "
          f"{train_stats['peak_gb']:.2f}), loss {first['total']:.5f} -> {last['total']:.5f}, "
          f"aiap {first['aiap']:.3e} -> {last['aiap']:.3e}, decoder input width {width}, "
          f"{wall:.1f} s in all (setup included), on {card}")
    if width != 64 + 2 * 2 * 6:
        _fail(f"the decoder takes {width} inputs, not 88")
    fwd_err, bwd_err, _ = _hold_train_batch(recorder.rec, card, "AIAP train batch", timed=False)
    errs_fwd.append(fwd_err)
    errs_bwd.append(bwd_err)
    cfg = Config.load(os.path.join(out1, "cfg_args.json"))
    assets = setup_avatar(cfg, device=device).assets
    knn_ms, knn_host_s = _knn_check(assets.query_points[:assets.num_valid], card)
    print(f"  (a) in {time.perf_counter() - t_phase:.1f} s")

    # (b) the SH render of one 1024^2 view, its gradient to the coefficients
    t_phase = time.perf_counter()
    scene, cam = _sh_scene(device)
    with _KernelRecorder() as recorder:
        (img, grad), counts, wall = _run_counted(_sh_render, scene, cam)
    print(f"  SH render: {SH_N} gaussians, degree {SH_DEG}, 1024x1024, forward and backward "
          f"in {wall * 1e3:.1f} ms (first call), launches {counts}")
    if counts["blend_fwd"] != 1 or counts["blend_bwd"] != 1:
        _fail(f"the SH render launched {counts}, not H-fwd and H-bwd once each")
    add(counts)
    rec = recorder.rec
    args = tuple(a.detach() if torch.is_tensor(a) else a for a in rec["fwd_args"][:6])
    res = _compare(blend_tiles(*args, caps=None), blend_tiles_plain(*args, caps=None))
    _check_blend("SH render, H-fwd", res)
    errs_fwd.append(max(res["color"], res["T"]))
    covered = float((img < 0.99).any(0).float().mean())
    scene_cpu = {k: v.cpu() for k, v in scene.items()}
    cam_cpu = type(cam)(*(x.cpu() if torch.is_tensor(x) else x for x in cam))
    t0 = time.perf_counter()
    img_cpu, grad_cpu = _sh_render(scene_cpu, cam_cpu)
    cpu_s = time.perf_counter() - t0
    scale = float(grad_cpu.abs().max())
    g_err = float((grad.cpu() - grad_cpu).abs().max())
    i_err = float((img.cpu() - img_cpu).abs().max())
    print(f"  SH render vs the CPU's plain path ({cpu_s:.1f} s there): {covered * 100:.1f}% of "
          f"pixels covered, max|d image| {i_err:.2e}, coefficients' gradient max|d| {g_err:.2e} "
          f"of max|grad| {scale:.2e} ({g_err / scale:.2e}, tol {TOL_SH_GRAD_REL:g})")
    if not bool(torch.isfinite(grad).all()) or scale == 0 or g_err > TOL_SH_GRAD_REL * scale:
        _fail("the SH render's coefficient gradient is not finite or disagrees with the CPU")
    print(f"  (b) in {time.perf_counter() - t_phase:.1f} s")

    # (c) the profiled run: 5 steps under torch.profiler, a Chrome trace
    t_phase = time.perf_counter()
    prof, n_prof = os.path.join(work, "prof"), 5
    argv = _train_argv(data, os.path.join(work, "out_prof")) + [
        "--max_steps", str(n_prof), "--profile_dir", prof]
    _, counts, wall = _run_counted(train_cli.main, argv)
    trace = os.path.join(prof, "trace.json")
    if not os.path.exists(trace):
        _fail("--profile_dir wrote no trace")
    # the trace holds the whole run, set-up included (hundreds of MB): scan
    # its text for the events' names instead of parsing it
    text = open(trace).read()
    n_of = lambda key: len(re.findall(r'"name": "[^"]*' + key, text))
    found = {key: n_of(key) for key in ("train::step", "blend_fwd_kernel", "blend_bwd_kernel")}
    print(f"  profiled run: {n_prof} steps, launches {counts}, {wall:.1f} s in all; "
          f"{len(text) / 2**20:.1f} MB trace, events named: {found}")
    del text
    if counts["blend_fwd"] != n_prof or counts["blend_bwd"] != n_prof \
            or any(n < n_prof for n in found.values()):
        _fail("the profiled run's trace does not name train::step and both kernels per step")
    add(counts)
    print(f"  (c) in {time.perf_counter() - t_phase:.1f} s")

    # (d) the pose-recovery leg on phase 5's (and 6's) save, 2 epochs
    t_phase = time.perf_counter()
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_quality_gate as gate

    epoch = ckpt.latest_epoch(out1, ckpt.TRAIN_NAME)
    with _KernelRecorder() as recorder:
        (result, _), counts, wall = _run_counted(gate.pose_recovery, out1, epoch, device,
                                                 2e-2, 2, 0.3)
    per_epoch = result["steps"] // 2
    n_render = 3 * min(max(gate.RENDER_FRAMES // 2, 1), per_epoch)
    expect = {**{name: 0 for name in counts}, "blend_fwd": per_epoch + result["steps"] + n_render,
              "blend_bwd": per_epoch + result["steps"]}
    print(f"  pose leg on iteration_{epoch}: launches {counts} (expected {expect}: the floor "
          f"epoch, {result['steps']} refinement steps, {n_render} renders), {wall:.1f} s in all")
    print("  pose leg (not gated here, a 38-step net): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in result.items()))
    if set(result) != POSE_KEYS or counts != expect:
        _fail("the pose leg's record or launch counts are not as expected")
    if not all(math.isfinite(v) for k, v in result.items() if k != "pass"):
        _fail("the pose leg's numbers are not finite")
    add(counts)
    fwd_err, bwd_err, _ = _hold_train_batch(recorder.rec, card, "pose leg's last batch",
                                            timed=False)
    errs_fwd.append(fwd_err)
    errs_bwd.append(bwd_err)
    print(f"  (d) in {time.perf_counter() - t_phase:.1f} s")
    return max(errs_fwd), max(errs_bwd), total


# phase 10: subjects of the multi-subject run (name, training frames), the
# run's steps, and the --dp runs' steps in stage 1 and stage 2
MULTI_SUBJECTS = (("subjA", 8), ("subjB", 8), ("subjC", 6), ("subjD", 6))
MULTI_STEPS = 20
DP_STEPS, DP2_STEPS = 10, 3
# --dp 2 against --dp 1 from one seed, relative differences of the global
# batch's loss. Each limit sits between the sound run's reading and a
# control run's, whose ranks break one piece of the data-parallel step
# (RANK_FAULTS; the readings in PERF.md, scripts/torch_dp_trajectory.py):
#  - the first step (the same parameters and frames; only the means over
#    the ranks' shares and the kernels' batch shapes differ): stage 1 at
#    the bf16 default against ranks that key depths for their own share,
#    not the global batch; stage 2 at the f32 decoder against ranks whose
#    BatchNorm takes its own share's statistics. At the bf16 default a
#    GEMM rounds by its shape (a rank's B/2 rows against B), so stage 2's
#    sound reading comes within 3x of that control's: the card cannot
#    separate them there, and 1e-2 is a sanity bound only;
#  - stage 1's 10-step trajectory at the f32 decoder, the largest
#    difference over the steps, against ranks that skip the gradient
#    all-reduce; a second --dp 1 run's spread is printed beside it. At
#    the bf16 default the trajectory is printed only: the bf16 rounding of
#    the BatchNorm-absorbed biases' noise (true gradient 0, Adam steps of
#    +-lr) moves a sound run within a few x of the control.
# tests/test_torch_frame_dp.py holds the step itself exactly and
# tests/test_torch_multi_cli.py a whole CPU run.
TOL_DP_FIRST = 2e-6
TOL_DP_FIRST_S2 = 1e-5
TOL_DP_FIRST_BF16 = 1e-2
TOL_DP_TRAJ = 3e-2
# Stage 2's BatchNorm sync at the f32 decoder, read where it acts: every
# BatchNorm running statistic that rank 0 saves after one step against the
# --dp 1 run's (_bn_apart). A rank that keeps its own share's statistics
# moves them by a tenth (momentum 0.9) of its share's distance from the
# global batch's. The first step's loss moves with them only as far as
# the frames' errors happen to cancel: ranks whose fused decoder skips its
# all-reduce read from 7.07e-6 to 6.9e-4 over runs from one seed (the
# stage-1 save they start from differs by the atomics of index_add_), so
# beside the loss's own limit that control is printed only. After one
# step, sound runs read about 4e-7 and the controls 2.1e-3 (fused decoder)
# and 0.107 (every BatchNorm) in each of three stage-1 saves
# (scripts/torch_dp_bn_probe.py). One step, not three: from the second
# step on, the biases before a BatchNorm take Adam's +-lr steps on
# rounding noise, and a sound run's statistics read up to 4.6e-3 after
# three.
TOL_DP_BN = 1e-4


def _metrics(out):
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    steps = {r["step"]: r for r in records if "step" in r}
    events = {r["event"]: r["value"] for r in records if "event" in r}
    return steps, events


class _LossRecorder:
    """While active, every step that engine/loop.train makes keeps its
    logged total (in a group, the global batch's)."""

    def __enter__(self):
        from gaussianavatar_torch.engine import loop

        self.loop, self.real = loop, loop.make_train_step
        self.totals = []

        def make(*a, **kw):
            step = self.real(*a, **kw)

            def recorded(*sa, **skw):
                terms, images = step(*sa, **skw)
                self.totals.append(terms["total"])
                return terms, images
            return recorded

        loop.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.loop.make_train_step = self.real

    def values(self):
        import torch

        return torch.stack(self.totals).float().cpu().tolist()


# The ranks of a `train --dp 2` run are spawned processes, and each imports
# this file as `__mp_main__` (the spawn start method runs the main script's
# top level). With RANK_HOOK_ENV set to {"record": path, "fault": name or
# null} (JSON), a rank installs _rank_hooks: rank 0 saves its last H-fwd and
# H-bwd inputs and its step losses to `record`, and a control run breaks the
# named piece of its step.
RANK_HOOK_ENV = "CHIP_SMOKE_RANK_HOOK"


def _no_grad_sync():
    from gaussianavatar_torch.parallel import mesh

    mesh.all_reduce_grads = lambda params, grp: None


def _no_bn_sync():
    from gaussianavatar_torch.parallel import mesh

    mesh.syncs_batch_stats = lambda: False


def _rank_depth_key():
    from gaussianavatar_torch.engine import train_step

    real = train_step.rasterize_views
    train_step.rasterize_views = lambda *a, config, **kw: real(
        *a, config=config._replace(key_views=0), **kw)


def _no_decoder_sync():
    """The fused decoder's statistics stay the rank's own; the UNet's
    BatchNorm still syncs."""
    from types import SimpleNamespace

    from gaussianavatar_torch.models import decoder

    decoder.mesh = SimpleNamespace(syncs_batch_stats=lambda: False,
                                   global_sum=decoder.mesh.global_sum)


RANK_FAULTS = {"no_grad_sync": _no_grad_sync, "no_bn_sync": _no_bn_sync,
               "rank_depth_key": _rank_depth_key, "no_decoder_sync": _no_decoder_sync}


def _rank_hooks(spec):
    import torch

    from gaussianavatar_torch.engine import loop
    from gaussianavatar_torch.parallel import mesh

    if spec["fault"]:
        RANK_FAULTS[spec["fault"]]()
    real_train = loop.train
    detach = lambda x: x.detach() if torch.is_tensor(x) else x

    def train(*a, **kw):
        with _KernelRecorder() as kernels, _LossRecorder() as losses:
            state = real_train(*a, **kw)
        if mesh.group().rank == 0:
            rec = {k: tuple(map(detach, v)) if isinstance(v, tuple)
                   else {kk: detach(vv) for kk, vv in v.items()} for k, v in kernels.rec.items()}
            torch.save({"blend": rec, "totals": losses.values()}, spec["record"])
        return state

    loop.train = train


def _dp_run(label, argv_for, out, dp, n_steps, fault=None):
    """`train` with `argv_for(out)` for n_steps with --dp dp (2: two ranks on
    the one card, recorded through _rank_hooks; `fault` breaks a piece of
    their step) -> {"totals": the global batch's loss at every step,
    "launches": summed over the ranks (exact: each rank launches each
    kernel once per step), "steps": metrics.jsonl's, "wall": s, "blend":
    rank 0's last H-fwd and H-bwd inputs (dp 2)}."""
    import torch

    from gaussianavatar_torch import train as train_cli

    argv = argv_for(out) + ["--dp", str(dp), "--max_steps", str(n_steps)]
    if dp == 1:
        with _LossRecorder() as losses:
            _, counts, wall = _run_counted(train_cli.main, argv)
        run = {"totals": losses.values(), "blend": None}
    else:
        record = os.path.join(out, "rank0_record.pt")
        os.environ[RANK_HOOK_ENV] = json.dumps({"record": record, "fault": fault})
        try:
            _, counts, wall = _run_counted(train_cli.main, argv)
        finally:
            del os.environ[RANK_HOOK_ENV]
        run = torch.load(record, map_location="cuda", weights_only=False)
    steps, events = _metrics(out)
    summed = events.get("kernel_launches")
    what = f"{label} --dp {dp}" + (f" ({fault})" if fault else "")
    print(f"  {what}: launches {summed} (from metrics.jsonl, summed over the ranks), "
          f"{wall:.1f} s in all (setup included)")
    for name in TRAIN_KERNELS:
        if summed is None or summed[name] != dp * n_steps:
            _fail(f"{what} launched {name} {summed and summed[name]} times, not once per "
                  "rank per step")
    if dp == 1 and counts != summed:
        _fail(f"{what}: the logged launches {summed} are not the counted {counts}")
    if len(run["totals"]) != n_steps or not all(map(math.isfinite, run["totals"])):
        _fail(f"{what}: {len(run['totals'])} step losses recorded, or not finite")
    return {**run, "launches": summed, "steps": steps, "wall": wall, "out": out}


def _apart(a, b, steps=None):
    """The largest relative difference of run b's step losses from run a's
    (over the first `steps`, or all)."""
    return max(abs(y - x) / abs(x) for x, y in list(zip(a["totals"], b["totals"]))[:steps])


def _bn_apart(a, b):
    """The largest difference of a BatchNorm running statistic in run b's
    newest save from run a's, relative to that buffer's largest entry in
    a, over every such buffer."""
    import torch

    from gaussianavatar_torch.engine import checkpoint as ckpt

    def load(run):
        out = run["out"]
        path = os.path.join(ckpt.ckpt_dir(out, ckpt.latest_epoch(out)), ckpt.CKPT_NAME)
        return torch.load(path, map_location="cpu", weights_only=True)

    sa, sb = load(a), load(b)
    keys = [k for k in sa if k.endswith(("running_mean", "running_var"))]
    if not keys:
        _fail(f"{a['out']}: the save holds no BatchNorm running statistics")
    return max(float((sb[k].double() - sa[k].double()).abs().max()
                     / sa[k].double().abs().max().clamp_min(1e-30)) for k in keys)


def phase_scale_out(device, card, work, train_stats):
    """Phase 10: (a) multi-subject training, resume and eval; (b) --dp 2 on
    the one card against --dp 1, stages 1 and 2. -> (H-fwd's error, H-bwd's
    error, launches)."""
    import shutil

    import torch

    from gaussianavatar_torch import eval as eval_cli, train_multi
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine import checkpoint as ckpt

    total = {}

    def add(counts):
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    # (a) 4 subjects of 512^2, unequal frame counts
    t_phase = time.perf_counter()
    root = os.path.join(work, "multi_data")
    written = {}
    for name, n in MULTI_SUBJECTS:
        d = os.path.join(root, name)
        if n in written:
            shutil.copytree(written[n], d)
        else:
            write_synthetic_dataset(d, n_train=n, n_test=4, image_size=512, device=device)
            written[n] = d
    S = len(MULTI_SUBJECTS)
    print(f"  wrote {S} subjects of 512x512 ({', '.join(f'{n}: {k}' for n, k in MULTI_SUBJECTS)}"
          f" training frames, 4 test frames each) in {time.perf_counter() - t_phase:.1f} s")
    out = os.path.join(work, "multi_out")
    argv = ["--sources", *(os.path.join(root, n) for n, _ in MULTI_SUBJECTS), "-m", out,
            "--train_stage", "1", "--dataset_type", "synthetic", "--pose_op_start_iter", "0"]
    torch.cuda.reset_peak_memory_stats()
    with _KernelRecorder() as recorder:
        _, counts, wall = _run_counted(train_multi.main, argv + ["--max_steps", str(MULTI_STEPS)])
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  kernel launches in the multi-subject run: {counts} ({MULTI_STEPS} steps x {S} "
          "subjects)")
    for name in TRAIN_KERNELS:
        if counts[name] != MULTI_STEPS * S:
            _fail(f"the multi-subject run launched {name} {counts[name]} times, not once per "
                  "subject per step")
    add(counts)
    spe = min(n for _, n in MULTI_SUBJECTS) // 2      # the fewest steps of any subject, B=2
    epoch = -(-MULTI_STEPS // spe)
    rates, losses = [], []
    for name, n in MULTI_SUBJECTS:
        d = os.path.join(out, name)
        steps, events = _metrics(d)
        saved = torch.load(os.path.join(ckpt.ckpt_dir(d, epoch), ckpt.TRAIN_NAME),
                           weights_only=True)
        net = torch.load(os.path.join(ckpt.ckpt_dir(d, epoch), ckpt.CKPT_NAME),
                         weights_only=True)
        if sorted(steps) != [1, 10, MULTI_STEPS] or saved["iteration"] != MULTI_STEPS \
                or net["pose_embedding"].shape[0] != n \
                or not os.path.exists(os.path.join(d, "log", "00001_pred.png")) \
                or events.get("kernel_launches") != counts:
            _fail(f"subject {name}: metrics, save or log PNG not as expected")
        if not all(math.isfinite(r["total"]) for r in steps.values()):
            _fail(f"subject {name}: loss not finite")
        rates.append((MULTI_STEPS - 10) / (steps[MULTI_STEPS]["t"] - steps[10]["t"]))
        losses.append((steps[1]["total"], steps[MULTI_STEPS]["total"]))
    rate = rates[0]
    print(f"  multi-subject training: {rate:.2f} it/s x {S} subjects steady (steps 10-"
          f"{MULTI_STEPS}) = {rate * S:.2f} subject-steps/s (phase 5: {train_stats['rate']:.2f} "
          f"it/s), peak memory {peak_gb:.2f} GiB (phase 5 {train_stats['peak_gb']:.2f}), loss "
          + ", ".join(f"{a:.4f} -> {b:.4f}" for a, b in losses)
          + f"; {wall:.1f} s in all (setup included), on {card}")
    fwd_err, bwd_err, _ = _hold_train_batch(recorder.rec, card, "multi-subject train batch "
                                            f"(subject {MULTI_SUBJECTS[-1][0]})", timed=False)

    # resume every subject for one epoch
    _, counts, wall = _run_counted(train_multi.main, argv + [
        "--checkpoint_epochs", str(epoch), "--epochs", str(epoch + 1)])
    add(counts)
    for name, _ in MULTI_SUBJECTS:
        saved = torch.load(os.path.join(ckpt.ckpt_dir(os.path.join(out, name), epoch + 1),
                                        ckpt.TRAIN_NAME), weights_only=True)
        if saved["iteration"] != MULTI_STEPS + spe \
                or saved["optimizer"]["net"]["count"] != MULTI_STEPS + spe:
            _fail(f"subject {name}: the resumed run did not go on from iteration {MULTI_STEPS}")
    print(f"  resumed {S} subjects from epoch {epoch}: {spe} steps to iteration "
          f"{MULTI_STEPS + spe}, launches {counts}, {wall:.1f} s in all")
    if any(counts[name] != spe * S for name in TRAIN_KERNELS):
        _fail("the resumed multi-subject run did not launch each kernel once per subject per "
              "step")

    subject = MULTI_SUBJECTS[-1][0]
    result, counts, wall = _run_counted(eval_cli.main, ["-m", os.path.join(out, subject)])
    print(f"  eval of {subject}: {result['frames']} test frames, PSNR {result['psnr']:.3f} SSIM "
          f"{result['ssim']:.5f}, launches {counts}, {wall:.1f} s in all")
    if not math.isfinite(result["psnr"]) or counts["blend_fwd"] != 1 or counts["blend_bwd"]:
        _fail("the multi-subject eval is not finite or did not launch H-fwd once")
    add(counts)
    print(f"  (a) in {time.perf_counter() - t_phase:.1f} s")

    # (b) --dp 2 on the one card against --dp 1, stage 1 then stage 2, each
    # beside control runs; every check once every reading is printed.
    # `checks`: (what, (sound, control or None), limit)
    t_phase = time.perf_counter()
    data = os.path.join(work, "data")
    checks, holds = [], []
    run = lambda label, argv, name, dp, n, fault=None: _dp_run(
        label, argv, os.path.join(work, f"dp_{name}"), dp, n, fault)
    s1 = lambda out: _train_argv(data, out)
    dp1, dp2 = (run("stage 1", s1, f"s1_dp{dp}", dp, DP_STEPS) for dp in (1, 2))
    own_key = run("stage 1", s1, "s1_rank_depth_key", 2, 1, "rank_depth_key")
    s1_f32 = lambda out: s1(out) + ["--bf16_decoder", "0"]
    dp1_f32, dp1b_f32, dp2_f32 = (run("stage 1 (f32 decoder)", s1_f32, f"s1_f32_{name}", dp,
                                      DP_STEPS) for name, dp in (("dp1", 1), ("dp1_again", 1),
                                                                 ("dp2", 2)))
    no_grad = run("stage 1 (f32 decoder)", s1_f32, "s1_f32_no_grad_sync", 2, DP_STEPS,
                  "no_grad_sync")
    for r in (dp1, dp2, dp1_f32, dp1b_f32, dp2_f32):
        add(r["launches"])
    holds.append(("stage 1", dp2))
    first = (_apart(dp1, dp2, 1), _apart(dp1, own_key, 1))
    traj = (_apart(dp1_f32, dp2_f32), _apart(dp1_f32, no_grad))
    print(f"  stage 1, step 1 vs --dp 1: --dp 2 {first[0]:.2e}, ranks keying depth for their "
          f"own share {first[1]:.2e} (limit {TOL_DP_FIRST:g}); at the f32 decoder "
          f"{_apart(dp1_f32, dp2_f32, 1):.2e}")
    print(f"  stage 1 (f32 decoder), steps 1-{DP_STEPS} vs --dp 1, largest: --dp 2 "
          f"{traj[0]:.2e}, a second --dp 1 run {_apart(dp1_f32, dp1b_f32):.2e}, ranks without "
          f"the gradient all-reduce {traj[1]:.2e} (limit {TOL_DP_TRAJ:g}); at the bf16 default "
          f"(printed only) --dp 2 {_apart(dp1, dp2):.2e}")
    checks += [("stage 1 first step", first, TOL_DP_FIRST),
               (f"stage 1 (f32 decoder) steps 1-{DP_STEPS}", traj, TOL_DP_TRAJ)]
    # between the first logged step (the end of the first 4-batch epoch)
    # and the last
    first_logged = min(dp1["steps"])
    rate = lambda r: ((DP_STEPS - first_logged)
                      / (r["steps"][DP_STEPS]["t"] - r["steps"][first_logged]["t"]))
    print(f"  stage 1, steps {first_logged + 1}-{DP_STEPS}: {rate(dp1):.2f} it/s (--dp 1) vs "
          f"{rate(dp2):.2f} "
          f"global it/s (--dp 2, two ranks sharing the card: the cost of sharing, no "
          f"scaling), on {card}")

    out1 = os.path.join(work, "out")
    stage1 = ckpt.ckpt_dir(out1, ckpt.latest_epoch(out1, ckpt.TRAIN_NAME))
    s2 = lambda out: ["-s", data, "-m", out, "--train_stage", "2", "--stage1_out_path", stage1,
                      "--dataset_type", "synthetic", "--no_lpips"]
    for dtype, extra, tol, separates in (("f32", ["--bf16_decoder", "0"], TOL_DP_FIRST_S2, True),
                                         ("bf16", [], TOL_DP_FIRST_BF16, False)):
        label = f"stage 2 ({dtype} decoder)"
        argv = lambda out: s2(out) + extra
        r1, r2 = (run(label, argv, f"s2_{dtype}_dp{dp}", dp, DP2_STEPS) for dp in (1, 2))
        no_bn = run(label, argv, f"s2_{dtype}_no_bn_sync", 2, 1, "no_bn_sync")
        add(r1["launches"])
        add(r2["launches"])
        holds.append((label, r2))
        first = (_apart(r1, r2, 1), _apart(r1, no_bn, 1))
        print(f"  {label}, step 1 vs --dp 1: --dp 2 {first[0]:.2e}, ranks with their own "
              f"share's BatchNorm statistics {first[1]:.2e} (limit {tol:g}"
              + (", that control printed only" if separates else ", a sanity bound")
              + f"); steps 1-{DP2_STEPS} {_apart(r1, r2):.2e}; {DP2_STEPS} steps in "
              f"{r1['wall']:.1f} s (--dp 1) and {r2['wall']:.1f} s (--dp 2, set-up and the "
              "spawn included)")
        checks.append((f"{label} first step", (first[0], None), tol))
        if separates:
            # the statistics after the control's one step, beside one-step runs
            one = [run(label, argv, f"s2_{dtype}_dp{dp}_one_step", dp, 1) for dp in (1, 2)]
            for r in one:
                add(r["launches"])
            stats = (_bn_apart(one[0], one[1]), _bn_apart(one[0], no_bn))
            print(f"  {label}, BatchNorm running statistics after one step vs --dp 1: --dp 2 "
                  f"{stats[0]:.2e}, ranks with their own share's {stats[1]:.2e} (limit "
                  f"{TOL_DP_BN:g})")
            checks.append((f"{label} BatchNorm running statistics", stats, TOL_DP_BN))

    # rank 0's last H-fwd and H-bwd inputs against the plain versions
    for label, r in holds:
        f_err, b_err, _ = _hold_train_batch(r["blend"], card, f"{label} --dp 2, rank 0's last "
                                            "batch", timed=False)
        fwd_err, bwd_err = max(fwd_err, f_err), max(bwd_err, b_err)
    for what, (sound, broken), tol in checks:
        if not sound <= tol:
            _fail(f"{what}: --dp 2 is {sound:.2e} from --dp 1, over the limit {tol:g}")
        if broken is not None and not broken > tol:
            _fail(f"{what}: the control run ({broken:.2e}) is within the limit {tol:g}, which "
                  "therefore separates nothing")
    print(f"  (b) in {time.perf_counter() - t_phase:.1f} s")
    return fwd_err, bwd_err, total


# phase 11: the fused POP decoder (`--fused_decoder 1`), on phase 5's data
DECODER_KERNELS = ("decoder_stats", "decoder_stage_fwd", "decoder_stage_bwd")
# launches per decode: a training decode takes x5's statistics once for its
# three stages (9 H-dstat), runs 11 fused stages forward and 11 backward; a
# decode in eval mode (the debug dump at step 1, eval, renders) runs the
# 11 forwards alone. Stage 2 decodes its B frames in one call.
TRAIN_DECODE = {"decoder_stats": 9, "decoder_stage_fwd": 11, "decoder_stage_bwd": 11}
EVAL_DECODE = {"decoder_stats": 0, "decoder_stage_fwd": 11, "decoder_stage_bwd": 0}
FUSED_STEPS, FUSED_F32_STEPS, FUSED_S2_STEPS, FUSED_MULTI_STEPS = TRAIN_STEPS, 10, 3, 3
BF16_FLOP_PER_S = 989e12      # H100 SXM, dense bfloat16 on the tensor cores
# the canonical stage-2 decode: B = 2 frames x 222,784 valid points (stage
# 1 decodes one copy, 222,784 rows); the stage inputs the decoder gives its
# kernels: the first stage's float32 features (64 + 2 uv), the hidden
# stages' 128, the skip stage's 66 + 128, in the bf16 and the f32 decoder
DECODER_ROWS = 445_568
DECODER_CASES = (("first stage, bf16 decoder", 66, "float32", "bfloat16"),
                 ("hidden stage, bf16 decoder", 128, "bfloat16", "bfloat16"),
                 ("skip stage, bf16 decoder", 194, "bfloat16", "bfloat16"),
                 ("hidden stage, f32 decoder", 128, "float32", "float32"))
# the other widths the JAX decoder takes (--hsize H: the stage inputs 66, H
# and 66 + H; --c_geom 63: an odd first and skip stage, 65 and 193 at
# H = 128), held at the same rows and limits and timed: (label, C, x dtype,
# compute dtype, H)
DECODER_WIDTH_CASES = tuple(
    (f"hsize {H}, {what}", C, x_dt, cdt, H)
    for H in (64, 96, 256)
    for what, C, x_dt, cdt in (("first stage", 66, "float32", "bfloat16"),
                               ("hidden stage", H, "bfloat16", "bfloat16"),
                               ("skip stage", 66 + H, "bfloat16", "bfloat16"))) + (
    ("c_geom 63, first stage", 65, "float32", "bfloat16", 128),
    ("c_geom 63, skip stage", 193, "bfloat16", "bfloat16", 128),
    ("hsize 96, f32 decoder, first stage", 66, "float32", "float32", 96),
    ("hsize 256, f32 decoder, skip stage", 322, "float32", "float32", 256),
    ("c_geom 63, f32 decoder, first stage", 65, "float32", "float32", 128))
# short fused trainings at the other widths through the CLI (F15)
WIDTH_RUNS = (("hsize 96, c_geom 63", ["--hsize", "96", "--c_geom", "63"]),
              ("hsize 256", ["--hsize", "256"]))
WIDTH_STEPS = 5
# f32 operations per element of the epilogues (softplus: the bias add, max,
# |.|, exp, log1p, the sum) and of H-dbwd (negation, exp, 1 - ., the
# product, the column sum); exp counts as one operation, so the bounds err low
DFWD_EPILOGUE_FLOPS, DBWD_FLOPS = 6, 5
# the decoder kernels against their plain versions on the same inputs:
# H-dstat's Gram and column sums within this share of their largest
# |entry| (the plain version sums in float64, the kernel in float32);
# H-dfwd within one
# bfloat16 ulp of the output's largest magnitude (the product's sum order
# can flip a rounding), at float32 within this share of it; H-dbwd's du
# within one ulp of each element, its bias gradient within this share of
# the largest column's sum of |du|. H-dstat and H-dbwd are bit-identical
# across runs.
TOL_DSTAT = 1e-5
TOL_DFWD_F32 = 1e-5
TOL_DBWD_SUM = 1e-5
# (c) evals of one checkpoint through the two decoders, both at the float32
# decoder (CROSS_ARGS), where they agree to float noise; at the bf16
# default they round at other places (the fold rounds Wp and bp to bf16,
# the reference normalises in float32), and a 30-step avatar's eval PSNR
# then moved 5e-3 to 1e-1 dB between runs (PERF.md), too close to the
# control to hold. The readings: the largest per-frame PSNR difference over
# the 4 test frames, and the mean |difference| of the novel-pose PNGs (8-bit
# levels). Each limit sits between the sound reading and a control's: the
# same checkpoint with one BatchNorm's running variance scaled by
# CONTROL_VAR_SCALE, through the same decoder.
CROSS_ARGS = ["--bf16_decoder", "0"]
TOL_CROSS_PSNR = 1e-3
TOL_CROSS_PNG = 1e-2
CONTROL_BN, CONTROL_VAR_SCALE = "pop.decoder.bn.3.running_var", 1.5


def _ulp(t):
    """One ulp of each element of t (bfloat16 or float32), at least the
    smallest normal number's."""
    import torch

    a = t.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - (7 if t.dtype == torch.bfloat16 else 23))


def _decoder_case(C, x_dtype, cdt, device, R=DECODER_ROWS, H=128):
    """Random inputs of one stage at its real width: x (positive, as an
    activation, except the first stage's features), folded weights and
    bias, and an output cotangent, from seed C (C + 1000 H off H = 128)."""
    import torch

    g = torch.Generator(device=device).manual_seed(C if H == 128 else C + 1000 * H)
    x = torch.randn(R, C, generator=g, device=device)
    if x_dtype == "bfloat16":
        x = torch.nn.functional.softplus(x)
    Wp = torch.randn(C, H, generator=g, device=device) / C ** 0.5
    bp = 0.1 * torch.randn(H, generator=g, device=device)
    cot = 1e-3 * torch.randn(R, H, generator=g, device=device)
    dt = lambda name: getattr(torch, name)
    return x.to(dt(x_dtype)), Wp.to(dt(cdt)), bp.to(dt(cdt)), cot.to(dt(cdt))


def _hold_stats(label, x):
    """H-dstat against its plain version -> max |kernel - plain|."""
    import torch

    from gaussianavatar_torch.ops import decoder_stage as ds

    s1, g1 = ds.column_stats(x)
    s2, g2 = ds.column_stats(x)
    sp, gp = ds.column_stats_plain(x)
    torch.cuda.synchronize()
    if not (torch.equal(s1, s2) and torch.equal(g1, g2)):
        _fail(f"H-dstat differs between two runs on the same inputs ({label})")
    eg, es = float((g1 - gp).abs().max()), float((s1 - sp).abs().max())
    rg, rs = eg / float(gp.abs().max()), es / float(sp.abs().max())
    print(f"  {label}, H-dstat ({x.shape[1]} wide, {str(x.dtype)[6:]}): Gram {rg:.2e}, column "
          f"sums {rs:.2e} of their largest (tol {TOL_DSTAT:g}); two runs identical")
    if not (rg <= TOL_DSTAT and rs <= TOL_DSTAT):
        _fail(f"H-dstat disagrees with its plain version ({label})")
    return max(eg, es)


def _hold_fwd(label, x, Wp, bp, act):
    """H-dfwd against its plain version -> max |kernel - plain|."""
    import torch

    from gaussianavatar_torch.ops import decoder_stage as ds

    z = ds.stage_fwd(x, Wp, bp, act)
    zp = ds.stage_fwd_plain(x, Wp, bp, act)
    d = (z.float() - zp.float()).abs()
    big = zp.float().abs().max()
    bf16 = Wp.dtype == torch.bfloat16
    tol = float(_ulp(big.to(Wp.dtype))) if bf16 else TOL_DFWD_F32 * float(big)
    err, moved = float(d.max()), float((d > 0).float().mean())
    print(f"  {label}, H-dfwd ({x.shape[1]} -> {Wp.shape[1]}, {act}, {str(Wp.dtype)[6:]}): "
          f"max|d z| {err:.3e} (tol {tol:.3e}: " + ("one bf16 ulp of" if bf16 else
                                            f"{TOL_DFWD_F32:g} x") + f" max|z| {float(big):.3g}), "
          f"{100 * moved:.3f}% of elements differ")
    if not err <= tol or not bool(torch.isfinite(z).all()):
        _fail(f"H-dfwd disagrees with its plain version ({label})")
    return err


def _hold_bwd(label, g, z, act):
    """H-dbwd against its plain version -> max |kernel - plain| (du)."""
    import torch

    from gaussianavatar_torch.ops import decoder_stage as ds

    du1, db1 = ds.stage_bwd(g, z, act)
    du2, db2 = ds.stage_bwd(g, z, act)
    dup, dbp = ds.stage_bwd_plain(g, z, act)
    torch.cuda.synchronize()
    if not (torch.equal(du1, du2) and torch.equal(db1, db2)):
        _fail(f"H-dbwd differs between two runs on the same inputs ({label})")
    d = (du1.float() - dup.float()).abs()
    over = int((d > _ulp(dup)).sum())
    scale = float(dup.float().abs().sum(0).max())
    rdb = float((db1 - dbp).abs().max()) / max(scale, 1e-30)
    print(f"  {label}, H-dbwd ({z.shape[1]} wide, {act}, {str(z.dtype)[6:]}): max|d du| "
          f"{float(d.max()):.3e}, "
          f"{over} elements over one ulp (tol 0); bias gradient {rdb:.2e} of the largest "
          f"column's sum |du| (tol {TOL_DBWD_SUM:g}); two runs identical")
    if over or not rdb <= TOL_DBWD_SUM:
        _fail(f"H-dbwd disagrees with its plain version ({label})")
    return float(d.max())


def _decoder_bounds(R, C, H, x_esize, c_esize, tensor_cores):
    """Least times (ms, bound_by) of the three kernels on one stage of
    input width C and output width H: the bytes (each input read once, each
    output written once) over HBM bandwidth against the operations over the
    peak of their type. H-dstat's least work is the Gram's distinct entries,
    R C (C + 1) operations (a product and an addition each) on x's type:
    H-dstat's products run on the tensor cores only for bfloat16 input."""
    peak = BF16_FLOP_PER_S if tensor_cores else FP32_FLOP_PER_S
    stat_peak = BF16_FLOP_PER_S if x_esize == 2 else FP32_FLOP_PER_S

    def bound(bytes_, t_ops):
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    stat = bound(R * C * x_esize + (C * C + C) * 4, R * C * (C + 1) / stat_peak * 1e3)
    fwd = bound(R * C * x_esize + (C * H + H) * c_esize + R * H * c_esize,
                2 * R * C * H / peak * 1e3 + DFWD_EPILOGUE_FLOPS * R * H / FP32_FLOP_PER_S * 1e3)
    bwd = bound(3 * R * H * c_esize + H * 4, DBWD_FLOPS * R * H / FP32_FLOP_PER_S * 1e3)
    return {"decoder_stats": stat, "decoder_stage_fwd": fwd, "decoder_stage_bwd": bwd}


def _decoder_random_holds(device, card):
    """(a) the three kernels against their plain versions on random inputs
    at the canonical stage shapes and at the other widths
    (DECODER_WIDTH_CASES), each timed beside its bound and its library
    yardstick -> ({kernel: numbers of the 128-wide bf16 stage}, {kernel:
    max |error|})."""
    import torch

    from gaussianavatar_torch.ops import decoder_stage as ds

    errs = {k: 0.0 for k in DECODER_KERNELS}
    rows = {}
    cases = [c + (128,) for c in DECODER_CASES] + list(DECODER_WIDTH_CASES)
    for label, C, x_dt, cdt, H in cases:
        x, Wp, bp, cot = _decoder_case(C, x_dt, cdt, device, H=H)
        errs["decoder_stats"] = max(errs["decoder_stats"], _hold_stats(label, x))
        acts = ("softplus", "relu") if C == H and cdt == "bfloat16" else ("softplus",)
        for act in acts:
            errs["decoder_stage_fwd"] = max(errs["decoder_stage_fwd"],
                                            _hold_fwd(label, x, Wp, bp, act))
            z = ds.stage_fwd(x, Wp, bp, act)
            errs["decoder_stage_bwd"] = max(errs["decoder_stage_bwd"],
                                            _hold_bwd(label, cot, z, act))
        z = ds.stage_fwd(x, Wp, bp, "softplus")
        xf, xc = x.float(), x.to(Wp.dtype)
        t = {
            "decoder_stats": (_time_ms(lambda: ds.column_stats(x), reps=20),
                              _time_ms(lambda: ds.column_stats_plain(x), reps=5, warmup=1),
                              _time_ms(lambda: torch.mm(xf.t(), xf), reps=20)),
            "decoder_stage_fwd": (_time_ms(lambda: ds.stage_fwd(x, Wp, bp, "softplus"), reps=20),
                                  _time_ms(lambda: ds.stage_fwd_plain(x, Wp, bp, "softplus"),
                                           reps=5, warmup=1),
                                  _time_ms(lambda: torch.addmm(bp, xc, Wp), reps=20)),
            "decoder_stage_bwd": (_time_ms(lambda: ds.stage_bwd(cot, z, "softplus"), reps=20),
                                  _time_ms(lambda: ds.stage_bwd_plain(cot, z, "softplus"),
                                           reps=5, warmup=1), None),
        }
        bounds = _decoder_bounds(DECODER_ROWS, C, H, x.element_size(), Wp.element_size(),
                                 cdt == "bfloat16")
        for name, (ms, plain_ms, lib_ms) in t.items():
            b_ms, b_by = bounds[name]
            lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
            print(f"  {label}: {name} {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}), library {lib} ({DECODER_ROWS} rows, {C} -> {H}); on {card}")
            if ms < b_ms:
                _fail(f"{label}: {name} reads {ms:.4f} ms, under its bound {b_ms:.4f} ms: the "
                      "bound counts more work than the function needs")
            if C == 128 and H == 128 and cdt == "bfloat16":
                rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": lib_ms}
        del x, Wp, bp, cot, z, xf, xc
    return rows, errs


class _DecoderRecorder:
    """While active, the decoder kernels' wrappers keep their last training
    call's inputs for each wrapper, width and dtype (H-dfwd's with autograd
    on; they launch as before). The debug dump's eval-mode decode, which the JAX
    loop's cadence puts after a run's last group, is not what the holds of
    "the last step" read."""

    NAMES = ("column_stats", "stage_fwd", "stage_bwd")

    def __enter__(self):
        import torch

        from gaussianavatar_torch.ops import decoder_stage

        self.mod = decoder_stage
        self.real = {n: getattr(decoder_stage, n) for n in self.NAMES}
        self.rec = {}

        def wrap(name):
            real = self.real[name]

            def call(*a):
                # H-dbwd runs inside a backward, where autograd is off
                if name != "stage_fwd" or torch.is_grad_enabled():
                    self.rec[(name, a[0].shape[1], a[0].dtype)] = tuple(
                        v.detach() if torch.is_tensor(v) else v for v in a)
                return real(*a)
            return call

        for n in self.NAMES:
            setattr(decoder_stage, n, wrap(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.real.items():
            setattr(self.mod, n, f)


def _hold_recorded(rec, label):
    """Each recorded decoder call's inputs through its kernel and its plain
    version -> {kernel: max |error|}."""
    errs = {k: 0.0 for k in DECODER_KERNELS}
    for (name, _, _), args in sorted(rec.items(), key=lambda kv: (kv[0][0], kv[0][1])):
        if name == "column_stats":
            errs["decoder_stats"] = max(errs["decoder_stats"], _hold_stats(label, *args))
        elif name == "stage_fwd":
            errs["decoder_stage_fwd"] = max(errs["decoder_stage_fwd"], _hold_fwd(label, *args))
        else:
            errs["decoder_stage_bwd"] = max(errs["decoder_stage_bwd"], _hold_bwd(label, *args))
    return errs


def _expect(what, counts, per_step, steps, evals=0, blend=None):
    """Fails unless `counts` holds each blend kernel once per step (or
    `blend`: (H-fwd, H-bwd) launches) and each decoder kernel per decode
    (`steps` training decodes, `evals` decodes in eval mode besides)."""
    fwd, bwd = blend if blend is not None else (steps, steps)
    want = {"blend_fwd": fwd, "blend_bwd": bwd}
    for k in DECODER_KERNELS:
        want[k] = per_step[k] * steps + EVAL_DECODE[k] * evals
    got = {k: counts.get(k) for k in want}
    print(f"  {what}: launches {got} (expected {want})")
    if got != want:
        _fail(f"{what} launched {got}, not {want}")


def _fused_train(label, argv, out, steps, card, train_stats=None):
    """`train` through the fused decoder for `steps` steps, the decoder
    kernels recorded -> (counts, recorder's inputs, steps' metrics)."""
    import torch

    from gaussianavatar_torch import train as train_cli

    torch.cuda.reset_peak_memory_stats()
    with _DecoderRecorder() as drec:
        _, counts, wall = _run_counted(train_cli.main, argv + ["--max_steps", str(steps)])
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # each debug dump decodes once more, in eval mode
    _expect(label, counts, TRAIN_DECODE, steps, evals=_dumps(steps))
    steps_m, _ = _metrics(out)
    first, last = min(steps_m), max(steps_m)
    if not all(math.isfinite(r["total"]) for r in steps_m.values()):
        _fail(f"{label}: loss not finite")
    line = (f"  {label}: loss {steps_m[first]['total']:.5f} at step {first} -> "
            f"{steps_m[last]['total']:.5f} at step {last}, peak memory {peak_gb:.2f} GiB, "
            f"{wall:.1f} s in all (setup included)")
    if steps > 10:
        _, rate, s0 = _train_rate(out, steps)
        line += f", {rate:.2f} it/s steady (steps {s0}-{steps})"
        if train_stats:
            line += (f"; phase 5 (reference decoder) {train_stats['rate']:.2f} it/s, "
                     f"{train_stats['peak_gb']:.2f} GiB")
    print(line + f", on {card}")
    return counts, drec.rec, steps_m


def _eval_frames(out, fused):
    """eval of `out`'s newest save through the fused or the reference
    decoder, at the float32 decoder -> (per-frame PSNR, counts)."""
    from gaussianavatar_torch import eval as eval_cli

    result, counts, _ = _run_counted(eval_cli.main, ["-m", out, "--fused_decoder", str(fused)]
                                     + CROSS_ARGS)
    return result["frame_psnr"], counts


def _novel_pose_pngs(out, data, fused):
    """render_novel_pose of the test split's poses at 512^2, at the float32
    decoder -> (the PNGs as one uint8 array, counts)."""
    import numpy as np
    from PIL import Image

    from gaussianavatar_torch import render_novel_pose

    _, counts, _ = _run_counted(render_novel_pose.main, [
        "-m", out, "--fused_decoder", str(fused), "--image_size", "512",
        "--test_folder", os.path.join(data, "test")] + CROSS_ARGS)
    d = os.path.join(out, "novel_pose")
    return np.stack([np.asarray(Image.open(os.path.join(d, n)))
                     for n in sorted(os.listdir(d)) if n.endswith(".png")]), counts


def _control_copy(out, dst):
    """A copy of `out` whose newest save has CONTROL_BN scaled by
    CONTROL_VAR_SCALE."""
    import shutil

    import torch

    from gaussianavatar_torch.engine import checkpoint as ckpt

    shutil.copytree(out, dst, ignore=shutil.ignore_patterns("log", "novel_pose", "test_free"))
    path = os.path.join(ckpt.ckpt_dir(dst, ckpt.latest_epoch(dst)), ckpt.CKPT_NAME)
    sd = torch.load(path, weights_only=True)
    sd[CONTROL_BN] = sd[CONTROL_BN] * CONTROL_VAR_SCALE
    torch.save(sd, path)
    return dst


def phase_fused_decoder(device, card, work, train_stats):
    """Phase 11: the fused decoder. (a) H-dstat, H-dfwd and H-dbwd against
    their plain versions at the canonical stage shapes and the other widths,
    timed; (b) stage-1 training through it (bf16, then f32), stage 2 from
    phase 7's stage-1 save, and short stage-1 runs at --hsize 96 --c_geom 63
    and --hsize 256, exact launches, each run's last decoder inputs held; (c) the
    checkpoints cross-loaded between the decoders through eval and
    render_novel_pose, against a perturbed control; (d) `--dp 2` against
    `--dp 1` in stage 2 (f32 decoder), against ranks whose fused decoder
    skips its statistics all-reduce; (e) train_multi, render_novel_view and
    export_avatar_ply through it -> ({kernel: JSON numbers}, launches on the
    main paths)."""
    from gaussianavatar_torch.engine import checkpoint as ckpt

    total = {k: 0 for k in DECODER_KERNELS}

    def add(counts):
        for k in total:
            total[k] += counts.get(k, 0)

    t_part = time.perf_counter()
    rows, errs = _decoder_random_holds(device, card)
    print(f"  (a) in {time.perf_counter() - t_part:.1f} s")

    def held(rec, label):
        for k, v in _hold_recorded(rec, label).items():
            errs[k] = max(errs[k], v)

    # (b) training through the fused decoder
    t_part = time.perf_counter()
    data = os.path.join(work, "data")
    fused_out = os.path.join(work, "fused_out")
    counts, rec, _ = _fused_train("stage 1, bf16 fused decoder",
                                  _train_argv(data, fused_out) + ["--fused_decoder", "1"],
                                  fused_out, FUSED_STEPS, card, train_stats)
    add(counts)
    held(rec, "stage-1 last step")
    f32_out = os.path.join(work, "fused_f32_out")
    counts, rec, _ = _fused_train("stage 1, f32 fused decoder", _train_argv(data, f32_out)
                                  + ["--fused_decoder", "1", "--bf16_decoder", "0"],
                                  f32_out, FUSED_F32_STEPS, card)
    add(counts)
    held(rec, "stage-1 f32 last step")
    out1 = os.path.join(work, "out")
    stage1 = ckpt.ckpt_dir(out1, ckpt.latest_epoch(out1, ckpt.TRAIN_NAME))
    s2 = lambda out: ["-s", data, "-m", out, "--train_stage", "2", "--stage1_out_path", stage1,
                      "--dataset_type", "synthetic", "--no_lpips", "--fused_decoder", "1"]
    s2_out = os.path.join(work, "fused_s2_out")
    counts, rec, steps_m = _fused_train("stage 2 (B = 2 frames in one decode), bf16 fused decoder",
                                        s2(s2_out), s2_out, FUSED_S2_STEPS, card)
    add(counts)
    if not all(math.isfinite(r["pose"]) and r["pose"] > 0 for r in steps_m.values()):
        _fail("fused stage 2: pose_loss not finite or no pose feature map")
    held(rec, "stage-2 last step")
    # the other widths the JAX decoder takes (F15): short fused stage-1 runs
    for label, flags in WIDTH_RUNS:
        out = os.path.join(work, "fused_" + "_".join(flags[1::2]))
        counts, rec, _ = _fused_train(f"stage 1, bf16 fused decoder, {label}",
                                      _train_argv(data, out) + ["--fused_decoder", "1"] + flags,
                                      out, WIDTH_STEPS, card)
        add(counts)
        held(rec, f"{label}, last step")
    print(f"  (b) in {time.perf_counter() - t_part:.1f} s")

    # (c) cross-loads: phase 5's reference checkpoint through both
    # decoders (eval and novel pose), (b)'s fused checkpoint through both,
    # each beside a control whose BatchNorm variance is perturbed
    t_part = time.perf_counter()
    import numpy as np

    readings = []
    for name, out in (("phase 5's reference checkpoint", out1),
                      ("(b)'s fused checkpoint", fused_out)):
        ctrl = _control_copy(out, os.path.join(work, "cross_control_" + os.path.basename(out)))
        native = 0 if out == out1 else 1
        p_nat, c1 = _eval_frames(out, native)
        p_x, c2 = _eval_frames(out, 1 - native)
        p_ctrl, c3 = _eval_frames(ctrl, native)
        for c in (c1, c2, c3):
            add(c)
        d_psnr = max(abs(a - b) for a, b in zip(p_nat, p_x))
        d_ctrl = max(abs(a - b) for a, b in zip(p_nat, p_ctrl))
        readings.append((f"{name}, eval PSNR", d_psnr, d_ctrl, TOL_CROSS_PSNR, "dB"))
        print(f"  {name}: eval PSNR {np.mean(p_nat):.3f} dB through its own decoder, "
              f"{np.mean(p_x):.3f} through the other; control {np.mean(p_ctrl):.3f}")
        if native == 0:
            img_nat, c1 = _novel_pose_pngs(out, data, 0)
            img_x, c2 = _novel_pose_pngs(out, data, 1)
            img_ctrl, c3 = _novel_pose_pngs(ctrl, data, 0)
            for c in (c1, c2, c3):
                add(c)
            if c2["decoder_stage_fwd"] < EVAL_DECODE["decoder_stage_fwd"]:
                _fail("the fused novel-pose render did not run H-dfwd")
            mad = lambda a, b: float(np.abs(a.astype(np.float64) - b).mean())
            readings.append((f"{name}, novel-pose PNGs", mad(img_nat, img_x),
                             mad(img_nat, img_ctrl), TOL_CROSS_PNG, "levels"))
        if c2["decoder_stage_fwd"] != (EVAL_DECODE["decoder_stage_fwd"] if native == 0 else 0):
            _fail(f"{name}: the eval through the other decoder launched {c2}")
    for what, sound, broken, tol, unit in readings:
        print(f"  {what}: the other decoder {sound:.3e} {unit} from its own, the control "
              f"{broken:.3e} (limit {tol:g})")
    for what, sound, broken, tol, _ in readings:
        if not sound <= tol:
            _fail(f"{what}: {sound:.3e} over the limit {tol:g}")
        if not broken > tol:
            _fail(f"{what}: the control ({broken:.3e}) is within the limit {tol:g}")
    print(f"  (c) in {time.perf_counter() - t_part:.1f} s")

    # (d) --dp 2 against --dp 1, stage 2 at the f32 fused decoder
    t_part = time.perf_counter()
    argv = lambda out: s2(out) + ["--bf16_decoder", "0"]
    runs = {}
    for name, dp, fault in (("dp1", 1, None), ("dp2", 2, None),
                            ("no_decoder_sync", 2, "no_decoder_sync")):
        runs[name] = _dp_run("fused stage 2 (f32 decoder)", argv,
                             os.path.join(work, f"fused_dp_{name}"), dp, 1, fault)
        summed = runs[name]["launches"]
        want = {k: TRAIN_DECODE[k] * dp + EVAL_DECODE[k] for k in DECODER_KERNELS}
        if {k: summed[k] for k in DECODER_KERNELS} != want:
            _fail(f"fused --dp {dp} ({name}) launched {summed}, not {want}")
        if fault is None:
            add(summed)
    sound = _apart(runs["dp1"], runs["dp2"], 1)
    broken = _apart(runs["dp1"], runs["no_decoder_sync"], 1)
    stats = (_bn_apart(runs["dp1"], runs["dp2"]), _bn_apart(runs["dp1"], runs["no_decoder_sync"]))
    print(f"  fused stage 2 (f32), step 1 vs --dp 1: --dp 2 {sound:.2e}, ranks whose fused "
          f"decoder skips the statistics all-reduce {broken:.2e} (limit {TOL_DP_FIRST_S2:g}, "
          f"that control printed only); BatchNorm running statistics after the step: --dp 2 "
          f"{stats[0]:.2e}, those ranks {stats[1]:.2e} (limit {TOL_DP_BN:g})")
    if not sound <= TOL_DP_FIRST_S2:
        _fail(f"fused --dp 2 is {sound:.2e} from --dp 1, over {TOL_DP_FIRST_S2:g}")
    if not stats[0] <= TOL_DP_BN:
        _fail(f"fused --dp 2's BatchNorm running statistics are {stats[0]:.2e} from --dp 1's, "
              f"over {TOL_DP_BN:g}")
    if not stats[1] > TOL_DP_BN:
        _fail(f"the fused --dp 2 control's BatchNorm running statistics ({stats[1]:.2e}) are "
              f"within {TOL_DP_BN:g}")
    print(f"  (d) in {time.perf_counter() - t_part:.1f} s")

    # (e) the other entry points through the fused decoder: train_multi on
    # two of phase 10's subjects, render_novel_view and export_avatar_ply of
    # (b)'s checkpoint
    t_part = time.perf_counter()
    from gaussianavatar_torch import export_avatar_ply, render_novel_view, train_multi

    S = 2
    sources_multi = [os.path.join(work, "multi_data", n) for n, _ in MULTI_SUBJECTS[:S]]
    _, counts, wall = _run_counted(train_multi.main, [
        "--sources", *sources_multi, "-m", os.path.join(work, "fused_multi_out"),
        "--train_stage", "1", "--dataset_type", "synthetic", "--pose_op_start_iter", "0",
        "--fused_decoder", "1", "--max_steps", str(FUSED_MULTI_STEPS)])
    _expect(f"train_multi, {S} subjects x {FUSED_MULTI_STEPS} steps ({wall:.1f} s)", counts,
            TRAIN_DECODE, S * FUSED_MULTI_STEPS)
    add(counts)
    _, counts, wall = _run_counted(render_novel_view.main, ["-m", fused_out, "--frames", "4"])
    pngs = sorted(os.listdir(os.path.join(fused_out, "novel_view", "pose_0")))
    _expect(f"render_novel_view of (b)'s checkpoint, {len(pngs)} frames ({wall:.1f} s)", counts,
            TRAIN_DECODE, 0, evals=1, blend=(1, 0))
    add(counts)
    _, counts, wall = _run_counted(export_avatar_ply.main, ["-m", fused_out])
    plys = [n for n in os.listdir(fused_out) if n.endswith(".ply")]
    _expect(f"export_avatar_ply of (b)'s checkpoint, {plys} ({wall:.1f} s)", counts,
            TRAIN_DECODE, 0, evals=1, blend=(0, 0))
    add(counts)
    if len(pngs) != 4 or not plys:
        _fail("the fused novel view or export wrote no frames or no PLY")
    print(f"  (e) in {time.perf_counter() - t_part:.1f} s")

    sources = {"decoder_stats": "decoder_stats.cu", "decoder_stage_fwd": "decoder_stage_fwd.cu",
               "decoder_stage_bwd": "decoder_stage_bwd.cu"}
    # the JAX stage each kernel stands in for (no pallas_call: XLA fuses it)
    replaces = {"decoder_stats": "gaussianavatar_tpu/models/decoder.py:207",
                "decoder_stage_fwd": "gaussianavatar_tpu/models/decoder.py:220",
                "decoder_stage_bwd": "gaussianavatar_tpu/models/decoder.py:130"}
    kernels = [{"name": k, "route": "cuda", "source": f"gaussianavatar_torch/csrc/{sources[k]}",
                "replaces": replaces[k], "launches": total[k], "max_abs_err": errs[k],
                **rows[k]} for k in DECODER_KERNELS]
    return kernels, total


# phase 12: --steps_per_dispatch. The campaign's data (48 frames of 512^2,
# 24 batches an epoch: three full groups of 8), two epochs, S=8 against S=1
# from one seed; stage 2 on (a)'s save for 24 steps (one epoch, 3 groups).
SPD, SPD_FRAMES, SPD_STEPS, SPD_STEPS_S2 = 8, 48, 48, 24
# the group whose static buffers a control run leaves unrefreshed (a
# replay: the first group runs eagerly and captures); the gate flip's is
# the first replay after the flip
SPD_STALE_GROUP = {"stage 1": 2, "stage 1 fused": 2, "stage 2": 2, "gate flip": 5}
# S=8 against S=1 as users run them: `index_add_` adds in no fixed order
# (F5) and the bf16 step amplifies that within a few steps (two S=1 runs
# part by 1e-3 to 6e-2 of the loss over 16 steps), so the loss over the
# first two groups (the eager group, then the first replay, the control's
# stale one) is held within a limit between the sound run's reading and
# the control's (the readings in PERF.md). Under torch's deterministic
# algorithms (`_deterministic`) the same comparison is exact: every step's
# loss and every tensor of the final state equal bit for bit, and each
# control differs.
TOL_SPD_LOSS = {"stage 1": 0.3, "stage 1 fused": 0.3, "stage 2": 1e-2}


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms (warnings only where an op has
    none: then it is order-free here, e.g. a scatter's amax)."""
    import warnings

    import torch

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


class _DispatchRecorder:
    """While active: every training step's total loss (single steps and the
    (S,) totals of each dispatch), a synchronised timestamp at each
    iteration that is a multiple of SPD, the graphs captured (with their
    capture seconds) and replayed; with `stale` = k, the k-th dispatch gets
    the (k-1)-th's feeds again, so its static buffers keep the previous
    group (the control)."""

    def __init__(self, stale=None):
        self.stale = stale

    def __enter__(self):
        import torch

        from gaussianavatar_torch.engine import loop, train_step

        self.loop, self.ts = loop, train_step
        self.real = (loop.make_train_step, loop.make_train_steps, train_step.GraphReplay)
        self.totals, self.stamps, self.captures = [], {}, []
        self.replays = self.dispatches = 0
        rec, prev = self, {}

        def stamp(state):
            if state.iteration % SPD == 0:
                torch.cuda.synchronize()
                rec.stamps[state.iteration] = time.perf_counter()

        def make_step(*a, **kw):
            fn = rec.real[0](*a, **kw)

            def step(state, *sa, **skw):
                terms, images = fn(state, *sa, **skw)
                rec.totals.append(terms["total"].reshape(1))
                stamp(state)
                return terms, images
            return step

        def make_steps(*a, **kw):
            fn = rec.real[1](*a, **kw)

            def steps(state, feeds, *sa, **skw):
                rec.dispatches += 1
                if rec.dispatches == rec.stale:
                    feeds = prev["feeds"]
                prev["feeds"] = feeds
                terms, images = fn(state, feeds, *sa, **skw)
                rec.totals.append(terms["total"])
                stamp(state)
                return terms, images
            return steps

        class Graph(self.real[2]):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec.captures.append(self.capture_s)

            def replay(self):
                rec.replays += 1
                return super().replay()

        loop.make_train_step, loop.make_train_steps, train_step.GraphReplay = (
            make_step, make_steps, Graph)
        return self

    def __exit__(self, *exc):
        self.loop.make_train_step, self.loop.make_train_steps, self.ts.GraphReplay = self.real

    def values(self):
        import torch

        return torch.cat(self.totals).float().cpu().tolist()


def _spd_run(label, argv, out, spd, steps, stale=None, fused=False, captures=None):
    """`train` with `argv` at --steps_per_dispatch `spd` for `steps` steps
    -> {totals, params (the saved net), rate: it/s from the end of group 2
    to the end, peak GiB, captures, replays, launches, recorder of the
    blend's last inputs}. Fails unless each blend kernel launched once a
    step (and, `fused`, each decoder kernel per decode) and `captures`
    graphs were captured."""
    import torch

    from gaussianavatar_torch import train as train_cli
    from gaussianavatar_torch.engine import checkpoint as ckpt

    torch.cuda.reset_peak_memory_stats()
    with _KernelRecorder() as kernels, _DispatchRecorder(stale) as rec:
        _, counts, wall = _run_counted(train_cli.main, argv + [
            "--steps_per_dispatch", str(spd), "--max_steps", str(steps)])
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    what = f"{label}, S={spd}" + (" (control: stale buffers)" if stale else "")
    totals = rec.values()
    if len(totals) != steps or not all(map(math.isfinite, totals)):
        _fail(f"{what}: {len(totals)} step losses recorded, or not finite")
    if fused:
        # one debug dump (after step 1, or after the first group of 8)
        _expect(what, counts, TRAIN_DECODE, steps, evals=1)
    else:
        for name in TRAIN_KERNELS:
            if counts[name] != steps:
                _fail(f"{what} launched {name} {counts[name]} times, not once per step")
    n_groups = steps // SPD
    if captures is not None:
        want = (captures, n_groups - captures) if spd > 1 else (0, 0)
        if (len(rec.captures), rec.replays) != want:
            _fail(f"{what}: {len(rec.captures)} graphs captured and {rec.replays} replays, not "
                  f"{want}")
    rate = (steps - 2 * SPD) / (rec.stamps[steps] - rec.stamps[2 * SPD])
    sd = torch.load(os.path.join(ckpt.ckpt_dir(out, ckpt.latest_epoch(out)), ckpt.CKPT_NAME),
                    weights_only=True)
    print(f"  {what}: {rate:.2f} it/s (steps {2 * SPD + 1}-{steps}), peak memory "
          f"{peak_gb:.2f} GiB, graphs captured in {[round(c, 3) for c in rec.captures]} s, "
          f"{rec.replays} replays, launches {counts}, loss {totals[0]:.5f} -> {totals[-1]:.5f}, "
          f"{wall:.1f} s in all (setup included)")
    return {"totals": totals, "params": sd, "rate": rate, "peak_gb": peak_gb,
            "captures": rec.captures, "replays": rec.replays, "launches": counts,
            "kernels": kernels.rec}


def _pair_count_cost(rec, card):
    """H-bwd and the scatter on a training step's recorded inputs, over the
    whole slot table (what the step runs since the graph needs a static
    length) against the binned prefix (what it ran before): the prefix's
    rows bit-identical, the rest 0; time and peak memory of each."""
    import torch

    from gaussianavatar_torch.ops.rasterize_tile import blend_tiles_bwd, scatter_pair_grads

    args, caps = _bwd_inputs(rec)
    n = int(args[2][-1])
    L = args[1].shape[0]
    prefix = (args[0], args[1][:n]) + args[2:]

    def run(a):
        return scatter_pair_grads(blend_tiles_bwd(*a, caps=caps), a[1], a[0].shape[0])

    full_rows, pre_rows = blend_tiles_bwd(*args, caps=caps), blend_tiles_bwd(*prefix, caps=caps)
    if not torch.equal(full_rows[:n], pre_rows) or bool(full_rows[n:].any()):
        _fail("H-bwd over the whole slot table does not give the prefix's rows and zeros")
    out = {}
    for name, a in (("whole table", args), ("binned prefix", prefix)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run(a)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        out[name] = (_time_ms(lambda: run(a), reps=20), peak)
    print(f"  the backward's static pair count: {L} slots, {n} binned; H-bwd + scatter "
          f"{out['whole table'][0]:.4f} ms and {out['whole table'][1]:.0f} MiB over the whole "
          f"table against {out['binned prefix'][0]:.4f} ms and {out['binned prefix'][1]:.0f} MiB "
          f"over the prefix, on {card}")
    return out


def _loss_apart(a, b, steps):
    """The largest relative difference of a step's loss over the first
    `steps` of run b from run a's."""
    return max(abs(y - x) / abs(x) for x, y in list(zip(a["totals"], b["totals"]))[:steps])


def _weights_apart(a, b):
    """The largest relative L2 distance of a weight tensor (two or more
    dimensions) after run b from run a's; printed, not held (the biases
    and BatchNorm affines that a BatchNorm follows move by Adam's +-lr on
    float noise)."""
    return max(float((b["params"][k].float() - v.float()).norm() / v.float().norm())
               for k, v in a["params"].items() if v.is_floating_point() and v.dim() >= 2)


def _state_apart(a, b):
    """(largest |difference| of a step's loss, of a final tensor) of run b
    from run a."""
    loss = max(abs(y - x) for x, y in zip(a["totals"], b["totals"]))
    state = max(float((b["params"][k].float() - v.float()).abs().max())
                for k, v in a["params"].items() if v.is_floating_point())
    return loss, state


def phase_dispatch(device, card, work):
    """Phase 12: --steps_per_dispatch 8 (a CUDA graph of 8 steps, replayed)
    against --steps_per_dispatch 1, each beside a control whose replay keeps
    one group's static batch buffers stale: (a) stage 1 on the campaign's
    48 frames, reference and fused decoders, 48 steps; (b) stage 2 on (a)'s
    save, 24 steps; (c) a gate flip inside the run (LPIPS from epoch 2, AIAP
    on), two captures; (d) (a)-(c) again under torch's deterministic
    algorithms, exact. -> (H-fwd's error, H-bwd's error, {kernel: launches}
    over every run)."""
    from gaussianavatar_torch import export_stage_1, gen_pose_map_frames
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine import checkpoint as ckpt
    from gaussianavatar_torch.ops.lpips import random_lpips_weights

    import numpy as np

    data = os.path.join(work, "data48")
    t0 = time.perf_counter()
    write_synthetic_dataset(data, n_train=SPD_FRAMES, n_test=2, image_size=512, device=device)
    print(f"  wrote {SPD_FRAMES} training frames of 512x512 in {time.perf_counter() - t0:.1f} s")
    checks, total = [], {}
    out = lambda name: os.path.join(work, f"spd_{name}")

    def run(label, argv_for, name, spd, steps, stale=None, fused=False, captures=1):
        got = _spd_run(label, argv_for(out(name)), out(name), spd, steps, stale, fused,
                       captures)
        for k, v in got["launches"].items():
            total[k] = total.get(k, 0) + v
        return got

    def hold(label, sound, control, again=None):
        steps = SPD_STALE_GROUP[label] * SPD
        s, c = _loss_apart(*sound, steps), _loss_apart(sound[0], control, steps)
        line = (f"  {label}, S=8 vs S=1: loss over steps 1-{steps} {s:.2e} (control {c:.2e}, "
                f"limit {TOL_SPD_LOSS[label]:g}); weights after the run {_weights_apart(*sound):.2e}"
                f" (control {_weights_apart(sound[0], control):.2e})")
        if again is not None:
            line += (f"; S=1 vs S=1: loss {_loss_apart(sound[0], again, steps):.2e}, weights "
                     f"{_weights_apart(sound[0], again):.2e}")
        print(line)
        checks.append((f"{label}: loss", (s, c), TOL_SPD_LOSS[label]))

    s1 = lambda extra: lambda o: _train_argv(data, o) + extra
    cases = {"stage 1": (s1([]), SPD_STEPS, False, 1),
             "stage 1 fused": (s1(["--fused_decoder", "1"]), SPD_STEPS, True, 1)}

    # (a) stage 1, reference then fused decoder
    t_phase = time.perf_counter()
    runs = {}
    for label, (argv_for, steps, fused, caps) in cases.items():
        key = label.replace(" ", "_")
        got = [run(label, argv_for, f"{key}_s{spd}{tag}", spd, steps, stale, fused, caps)
               for spd, stale, tag in ((1, None, ""), (SPD, None, ""),
                                       (SPD, SPD_STALE_GROUP[label], "_control"),
                                       (1, None, "_again"))]
        runs[label] = got
        hold(label, got[:2], got[2], again=got[3])
        print(f"  {label}: S=8 {got[1]['rate']:.2f} it/s against S=1 {got[0]['rate']:.2f} "
              f"({got[1]['rate'] / got[0]['rate']:.2f}x), peak memory {got[1]['peak_gb']:.2f} "
              f"against {got[0]['peak_gb']:.2f} GiB, capture {got[1]['captures'][0]:.3f} s, "
              f"on {card}")
    fwd_err, bwd_err, _ = _hold_train_batch(runs["stage 1"][1]["kernels"], card,
                                            "graph-replayed batch", timed=False)
    _pair_count_cost(runs["stage 1"][0]["kernels"], card)
    print(f"  (a) in {time.perf_counter() - t_phase:.1f} s")

    # (b) stage 2 on (a)'s S=8 save
    t_phase = time.perf_counter()
    s1_out = out("stage_1_s8")
    stage1 = ckpt.ckpt_dir(s1_out, ckpt.latest_epoch(s1_out, ckpt.TRAIN_NAME))
    export_stage_1.main(["-m", s1_out, "-s", data])
    gen_pose_map_frames.main(["--source_path", data, "--synthetic", "--size", "128"])
    cases["stage 2"] = (lambda o: ["-s", data, "-m", o, "--train_stage", "2", "--stage1_out_path",
                                   stage1, "--dataset_type", "synthetic", "--no_lpips"],
                        SPD_STEPS_S2, False, 1)
    argv_for, steps, _, _ = cases["stage 2"]
    got = [run("stage 2", argv_for, name, spd, steps, stale)
           for name, spd, stale in (("s2_s1", 1, None), ("s2_s8", SPD, None),
                                    ("s2_s8_control", SPD, SPD_STALE_GROUP["stage 2"]))]
    hold("stage 2", got[:2], got[2])
    print(f"  stage 2: S=8 {got[1]['rate']:.2f} it/s against S=1 {got[0]['rate']:.2f}, peak "
          f"memory {got[1]['peak_gb']:.2f} against {got[0]['peak_gb']:.2f} GiB, on {card}")
    print(f"  (b) in {time.perf_counter() - t_phase:.1f} s")

    # (c) the LPIPS gate flips at the boundary into epoch 2: a second capture
    t_phase = time.perf_counter()
    proj = os.path.join(work, "spd_lpips_project")
    os.makedirs(os.path.join(proj, "assets", "lpips"), exist_ok=True)
    np.savez(os.path.join(proj, "assets", "lpips", "lpips_alex.npz"), **random_lpips_weights(0))
    cases["gate flip"] = (lambda o: [a for a in _train_argv(data, o) if a != "--no_lpips"] + [
        "--use_aiap", "--lpips_start_iter", "1", "--project_path", proj], SPD_STEPS, False, 2)
    argv_for, steps, _, caps = cases["gate flip"]
    got = [run("gate flip", argv_for, name, spd, steps, captures=caps)
           for name, spd in (("flip_s1", 1), ("flip_s8", SPD))]
    print(f"  gate flip: S=8 {got[1]['rate']:.2f} it/s against S=1 {got[0]['rate']:.2f} (the S=8 "
          f"run captures a second graph inside the window), peak memory {got[1]['peak_gb']:.2f} "
          f"against {got[0]['peak_gb']:.2f} GiB")
    print(f"  (c) in {time.perf_counter() - t_phase:.1f} s")

    # (d) every case again under the deterministic algorithms: exact
    t_phase = time.perf_counter()
    with _deterministic():
        for label, (argv_for, steps, fused, caps) in cases.items():
            key = "det_" + label.replace(" ", "_")
            got = [run(f"{label}, deterministic", argv_for, f"{key}_s{spd}{tag}", spd, steps,
                       stale, fused, caps)
                   for spd, stale, tag in ((1, None, ""), (SPD, None, ""),
                                           (SPD, SPD_STALE_GROUP[label], "_control"))]
            s, c = _state_apart(*got[:2]), _state_apart(got[0], got[2])
            print(f"  {label}, deterministic, S=8 vs S=1: largest |loss difference| {s[0]:.3e}, "
                  f"largest |final tensor difference| {s[1]:.3e} (control {c[0]:.3e}, "
                  f"{c[1]:.3e}; limit 0)")
            checks.append((f"{label}, deterministic: losses", (s[0], c[0]), 0.0))
            checks.append((f"{label}, deterministic: final state", (s[1], c[1]), 0.0))
    print(f"  (d) in {time.perf_counter() - t_phase:.1f} s")

    for what, (sound_v, control_v), limit in checks:
        if not sound_v <= limit < control_v:
            _fail(f"{what}: S=8 against S=1 {sound_v:.2e}, control {control_v:.2e}: the limit "
                  f"{limit:g} does not lie between them")
    return fwd_err, bwd_err, total


def main():
    # cuBLAS's workspace fixed (the size PyTorch gives it on this card), so
    # phase 12's runs under the deterministic algorithms reduce in one order
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        print("phase 9: the rest of single-subject training on phase 5's data: AIAP and the "
              "positional encoding, grid_knn, the SH render, the profiled run, the pose leg")
        t9 = time.perf_counter()
        p9_fwd_err, p9_bwd_err, p9_counts = phase_train_terms(device, card, work, train_stats)
        print(f"  phase 9 in {time.perf_counter() - t9:.1f} s")
        print("phase 10: the scale-out entry points: 4 subjects through train_multi, resume "
              "and eval; --dp 2 on the one card against --dp 1, stages 1 and 2")
        t10 = time.perf_counter()
        p10_fwd_err, p10_bwd_err, p10_counts = phase_scale_out(device, card, work, train_stats)
        print(f"  phase 10 in {time.perf_counter() - t10:.1f} s")
        print("phase 11: the fused decoder (--fused_decoder 1): its kernels at the canonical "
              "stage shapes, training (stages 1 and 2), cross-loads, --dp 2")
        t11 = time.perf_counter()
        decoder_kernels, _ = phase_fused_decoder(device, card, work, train_stats)
        print(f"  phase 11 in {time.perf_counter() - t11:.1f} s")
        print("phase 12: --steps_per_dispatch 8 (a CUDA graph of 8 training steps, replayed) "
              "against 1: stage 1 (both decoders), stage 2, a gate flip")
        t12 = time.perf_counter()
        p12_fwd_err, p12_bwd_err, p12_counts = phase_dispatch(device, card, work)
        print(f"  phase 12 in {time.perf_counter() - t12:.1f} s")
    # launches: each main path's run, added (the render's H-fwd, training's,
    # then the resumed run's, eval's and the novel view's, then stage 2's,
    # then phase 8's, then phase 9's, then phase 10's, then phase 12's; the
    # decoder kernels' phase 11's, then phase 12's)
    fwd["launches"] += (train_counts["blend_fwd"] + rest_counts["blend_fwd"]
                        + s2_counts["blend_fwd"] + p8_counts["blend_fwd"]
                        + p9_counts["blend_fwd"] + p10_counts["blend_fwd"]
                        + p12_counts["blend_fwd"])
    bwd["launches"] += (rest_counts["blend_bwd"] + s2_counts["blend_bwd"]
                        + p8_counts["blend_bwd"] + p9_counts["blend_bwd"]
                        + p10_counts["blend_bwd"] + p12_counts["blend_bwd"])
    for k in decoder_kernels:
        k["launches"] += p12_counts[k["name"]]
    fwd["max_abs_err"] = max(fwd["max_abs_err"], train_fwd_err, s2_fwd_err, p8_fwd_err,
                             p9_fwd_err, p10_fwd_err, p12_fwd_err)
    bwd["max_abs_err"] = max(bwd["max_abs_err"], s2_bwd_err, p8_bwd_err, p9_bwd_err,
                             p10_bwd_err, p12_bwd_err)
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [fwd, bwd] + decoder_kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__mp_main__" and os.environ.get(RANK_HOOK_ENV):
    _rank_hooks(json.loads(os.environ[RANK_HOOK_ENV]))

if __name__ == "__main__":
    sys.exit(main())
