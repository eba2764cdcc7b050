"""The training need table and the adaptive footprint: the port's
counterpart of the capacity machinery that `--ragged 1 --auto_cascade 1`
turn on in the JAX loop (gaussianavatar_tpu/engine/loop.py:195-395 and
550-630), which both packages' train CLIs default to above 256 queries
(config.resolve_train_raster_defaults).

- The need table (`caps`, (F, T) int32 on the device): for every training
  frame and tile, the depth at which the blend's early termination stops
  (ops/rasterize_tile.probe_tile_depths, the saturation probe: the network
  in eval mode at the inference iteration, every tile capped at
  PROBE_CAPACITY rows), times `ragged_margin` (1.5), at most
  PROBE_CAPACITY. Each training step gathers its frames' rows by pose_idx
  and the blend walks no deeper (the skipped pairs join the reported
  overflow). The table is built before the first epoch, from the initial
  network, and rebuilt after the first epoch and at every save epoch; it is
  updated in place, so a captured CUDA graph of the step reads the new caps.
- The adaptive footprint (`train_footprint_adapt`): the same probe counts
  the (gaussian, tile) pairs a footprint of `render_max_tiles_per_gaussian`
  (4) tiles would clip. Training takes that footprint once they are at most
  `train_footprint_eps` of all pairs and goes back to
  `max_tiles_per_gaussian` (9) at three times that; the loop then rebuilds
  its step for the new M.

What the JAX loop has and the port does not: a static chunk budget (the
port's kernels take the caps as data and need no grid size) and the sampled
retunes that skip its full probe (`retune_sample`): they save the JAX loop
a recompile and tens of seconds a retune, and the port probes every frame
at every retune.

Inside a data-parallel group every rank probes every frame; the table and
the footprint decision are then broadcast from rank 0, so the ranks never
disagree on them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from gaussianavatar_torch.data.dataset import collate
from gaussianavatar_torch.engine.inference import INFERENCE_ITERATION, _to_device, frame_gaussians
from gaussianavatar_torch.ops.projection import project_gaussians
from gaussianavatar_torch.ops.rasterize import RasterizeConfig
from gaussianavatar_torch.ops.rasterize_tile import footprint_drop, probe_tile_depths
from gaussianavatar_torch.parallel import mesh

# the probe's depth cap: it bounds the probe's cost and the largest cap
PROBE_CAPACITY = 4096


def enabled(cfg) -> bool:
    """Whether training runs with the need table (`--ragged 1 --auto_cascade 1`)."""
    return bool(cfg.raster.ragged) and bool(cfg.raster.auto_cascade)


def footprint_for(frac: Optional[float], cur_m: int, m_full: int, m_target: int,
                  eps: float) -> int:
    """The JAX loop's hysteresis: shrink to `m_target` once the clip
    fraction is at most `eps`, widen back to `m_full` at 3 `eps`."""
    if frac is None:
        return cur_m
    if cur_m > m_target and frac <= eps:
        return m_target
    if cur_m < m_full and frac >= 3.0 * eps:
        return m_full
    return cur_m


class NeedTable:
    """The need table and footprint of one training run: `caps` (the
    device table the step gathers from) and `M` (the footprint the step is
    built with). `frames` serves the training frames' cameras; `inp_bank`
    is stage 2's posmap bank (None in stage 1); `drop` the item keys the
    step does not read."""

    def __init__(self, cfg, bundle, frames, raster_cfg: RasterizeConfig, H: int, W: int,
                 drop=(), inp_bank: Optional[torch.Tensor] = None):
        r = cfg.raster
        self.bundle, self.H, self.W = bundle, H, W
        self.raster_cfg = raster_cfg
        self.margin = float(r.ragged_margin or 1.5)
        self.m_full = int(raster_cfg.max_tiles_per_gaussian)
        self.m_target = int(r.render_max_tiles_per_gaussian or 0)
        self.fp_adapt = bool(r.train_footprint_adapt) and 0 < self.m_target < self.m_full
        self.eps = float(r.train_footprint_eps)
        self.M = self.m_full
        device = bundle.assets.query_points.device
        ts = raster_cfg.tile_size
        self.T = math.ceil(W / ts) * math.ceil(H / ts)
        B, F = cfg.model.batch_size, len(frames)
        # the probe batches: every frame, B at a time, the last one wrapping
        # around to frame 0 (JAX's probe feeds); a frame keeps its first row
        self.feeds = []
        seen = set()
        for i in range(0, F, B):
            idxs = [(i + j) % F for j in range(B)]
            feed = _to_device({k: v for k, v in collate([frames[k] for k in idxs]).items()
                               if k not in drop and k != "original_image"}, device)
            if inp_bank is not None:
                rows = torch.as_tensor(idxs, device=device)
                feed["inp_pos_map"] = inp_bank[rows * 0 if inp_bank.shape[0] == 1 else rows]
            keep = [j for j, k in enumerate(idxs) if k not in seen]
            seen.update(idxs)
            self.feeds.append((torch.as_tensor([idxs[j] for j in keep], device=device),
                               torch.as_tensor(keep, device=device), feed))
        self.caps = torch.zeros((F, self.T), dtype=torch.int32, device=device)
        self.built = False
        # probe batches run so far: each decodes in eval mode and blends once
        self.probes = 0

    def config(self) -> RasterizeConfig:
        """The step's raster settings at the current footprint."""
        return self.raster_cfg._replace(max_tiles_per_gaussian=self.M)

    @torch.no_grad()
    def probe(self):
        """-> (needed depths (F, T) int64, [clipped pairs, all pairs] at
        the candidate footprint (int64, zeros without the adapt)), on the
        device, from the network in eval mode."""
        net = self.bundle.net
        mode = net.training
        net.eval()
        try:
            raw = torch.zeros(self.caps.shape, dtype=torch.int64, device=self.caps.device)
            clip = torch.zeros(2, dtype=torch.int64, device=self.caps.device)
            for rows, keep, feed in self.feeds:
                world, colors, scales3, rotations, opacity = frame_gaussians(
                    self.bundle, feed, INFERENCE_ITERATION)
                B, N = world.shape[:2]
                if rotations.dim() == 2:
                    rotations = rotations[None].expand(B, N, 4)
                opacity = opacity.reshape(-1, N).expand(B, N)
                projs = project_gaussians(
                    world, scales3, rotations, feed["world_view_transform"],
                    feed["full_proj_transform"], feed["tan_fovx"].reshape(B),
                    feed["tan_fovy"].reshape(B), self.H, self.W)
                if self.fp_adapt:
                    clip += torch.stack(footprint_drop(projs, opacity, self.H, self.W,
                                                       self.raster_cfg.tile_size, self.m_target))
                _, needed = probe_tile_depths(projs, colors, opacity, self.H, self.W,
                                              self.config(), PROBE_CAPACITY)
                raw[rows] = needed.reshape(B, self.T)[keep].to(torch.int64)
                self.probes += 1
        finally:
            net.train(mode)
        return raw, clip

    def refill(self):
        """Probe every frame and refill `caps`. -> (the candidate
        footprint's clip fraction, None without the adapt; [the pairs whose
        need outgrew the old caps, all needed pairs], None at the first
        build)."""
        raw, clip = self.probe()
        if mesh.group() is not None:
            dist.broadcast(raw, 0)
            dist.broadcast(clip, 0)
        drift = None
        if self.built:
            drift = [int(torch.clamp_min(raw - self.caps, 0).sum()), int(raw.sum())]
        self.caps.copy_(torch.clamp_max(torch.ceil(raw * self.margin), PROBE_CAPACITY))
        self.built = True
        frac = None
        if self.fp_adapt:
            dropped, total = (int(x) for x in clip.tolist())
            frac = dropped / max(total, 1)
        return frac, drift


def update(tables: Sequence[NeedTable], loggers, epoch: Optional[int] = None) -> bool:
    """Refill every subject's table, then one footprint for them all, from
    the worst subject's clip fraction (the JAX multi-subject loop's rule;
    one subject: its own), before the first epoch with `epoch` None, else
    at the retune after `epoch`. Each subject's logger gets the events, at a
    retune its own reading too (`ragged_retune`: its clip fraction at the
    candidate footprint and its drift). -> whether M changed (the step must
    be rebuilt)."""
    first = not tables[0].built
    fracs, drift = [], [0, 0]
    for s, (t, lg) in enumerate(zip(tables, loggers)):
        frac, d = t.refill()
        fracs.append(frac)
        if d is not None:
            drift = [drift[0] + d[0], drift[1] + d[1]]
            # the subject's own reading, of which the footprint takes the worst
            own = {"clip_frac_m4": frac, "drift": d[0] / max(d[1], 1)}
            lg.log_event("ragged_retune", own)
            if len(tables) > 1:
                print(f"subject {s} retune: candidate clip fraction "
                      + ("n/a" if frac is None else f"{frac:.3e}")
                      + f", need drift {own['drift']:.3e}")
    if not first:
        # the pairs whose need outgrew the caps of the last window: what the
        # margin failed to cover
        frac_drift = drift[0] / max(drift[1], 1)
        for lg in loggers:
            lg.log_event("ragged_drift", f"{frac_drift:.2e}")
        print(f"ragged need drift since last retune: {frac_drift:.2e} of contributing pairs "
              "outgrew the caps")
    worst = None if None in fracs else max(fracs)
    t0 = tables[0]
    new_m = footprint_for(worst, t0.M, t0.m_full, t0.m_target, t0.eps)
    changed = new_m != t0.M
    if changed:
        for t in tables:
            t.M = new_m
        for lg in loggers:
            lg.log_event("footprint_adapt", f"M {new_m} clip_frac {worst:.2e}")
        where = "" if epoch is None else f" (epoch-{epoch} retune)"
        print(f"train footprint{where}: M={new_m} (candidate clip fraction {worst:.2e})")
    if first:
        for t, lg, frac in zip(tables, loggers, fracs):
            fp_note = "" if frac is None else f" fp_clip {frac:.2e}"
            mean = float(t.caps.float().mean())
            lg.log_event("ragged_need_bank", f"frames {t.caps.shape[0]} mean cap "
                         f"{mean:.1f}{fp_note}")
            print(f"ragged need table: {t.caps.shape[0]} frames, mean cap {mean:.1f} rows per "
                  f"tile{fp_note}")
    return changed
