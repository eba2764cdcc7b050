"""The multi-subject training loop (counterpart of
gaussianavatar_tpu/engine/multi_loop.py): S avatars trained side by side in
lockstep on one card (parallel/multi_subject.py), and with a data-parallel
group each of them over the group's ranks as well (parallel/grid.py).

The JAX loop's semantics are kept:
  - subject s draws its batches from a `BatchLoader` seeded with s;
  - an epoch has the fewest steps of any subject (`steps_per_epoch` is the
    minimum over the subjects, the loaders are zipped), so the longer
    subjects are cut short every epoch; every subject's optimizer schedule
    is built from that minimum;
  - every subject gets its own `cfg_args.json`, `metrics.jsonl` and
    `log/NNNNN_pred.png` (every `log_iter` steps from the first) under its
    model path, and one line `iter ... loss/subject [...] (... it/s x S
    subjects)` reports the run at its first step and every 10 steps;
  - saves at the save epochs and at the end, as S single-subject
    checkpoints (engine/checkpoint.save_stacked_checkpoint), and
    `checkpoint_epochs` resumes every subject from its own;
  - no LPIPS term and no AIAP graph (the JAX grid step has neither).

In stage 2 every subject boots from the one `stage1_out_path`, as in the
JAX loop, where every subject's config comes from the same flags; the run
says so in one warning line (ROADMAP F14). A resumed run takes the saves
as they are: the JAX multi-subject loop runs `stage_load` only on a fresh
start.

Left out, as in the single-subject loop: the JAX loop's capacity
machinery (the shared chunk budget, need tables, tier pooling, fairness
telemetry, footprint adaptation).
"""

from __future__ import annotations

import os
import time
from os.path import join
from typing import List, Optional, Sequence

import numpy as np
import torch

from gaussianavatar_torch.config import Config
from gaussianavatar_torch.data.dataset import BatchLoader
from gaussianavatar_torch.engine import checkpoint as ckpt
from gaussianavatar_torch.engine.inference import require_device
from gaussianavatar_torch.engine.logging_utils import open_logger
from gaussianavatar_torch.engine.loop import (
    DROP_KEYS, adjust_loss_weights, build_gt_bank, input_posmap_bank, lpips_gate_value,
    pose_opt_gate_value, save_image_grid,
)
from gaussianavatar_torch.engine.optim import build_optimizer
from gaussianavatar_torch.engine.setup import setup_avatar
from gaussianavatar_torch.engine.train_step import TrainState
from gaussianavatar_torch.ops.rasterize import raster_config
from gaussianavatar_torch.parallel import mesh
from gaussianavatar_torch.parallel.grid import make_grid_step
from gaussianavatar_torch.parallel.multi_subject import Subject, check_subjects
from gaussianavatar_torch.utils.cuda_build import LAUNCHES, launches_since


def build_subjects(cfgs: Sequence[Config], device: str) -> tuple:
    """-> (subjects, loaders, steps_per_epoch): every subject's bundle, GT
    bank (stage 2: posmap bank) and TrainState on `device`, its loader
    seeded with its index, and the run's steps per epoch (the fewest of any
    subject)."""
    bundles = [setup_avatar(c, device=device, train=True) for c in cfgs]
    check_subjects(cfgs, bundles)
    loaders = [BatchLoader(b.frames, c.model.batch_size, seed=s)
               for s, (b, c) in enumerate(zip(bundles, cfgs))]
    steps_per_epoch = min(len(ld) for ld in loaders)
    stage = cfgs[0].model.train_stage
    subjects = []
    for b, c in zip(bundles, cfgs):
        gt_bank = build_gt_bank(b.frames, device)
        inp_bank = input_posmap_bank(c.model, b.frames, device) if stage == 2 else None
        b.net.train()
        state = TrainState(b.net, build_optimizer(b.net, cfgs[0].opt, steps_per_epoch, stage))
        subjects.append(Subject(b, state, gt_bank, inp_bank))
    return subjects, loaders, steps_per_epoch


def train_multi(
    cfgs: Sequence[Config],
    saving_epochs: Sequence[int],
    checkpoint_epochs: Sequence[int] = (),
    device: str = "cuda",
    max_steps: Optional[int] = None,
) -> List[TrainState]:
    """Train len(cfgs) subjects in lockstep; each cfg carries its own
    source_path and model_path, the rest is the first subject's. Stops once
    the iteration reaches `max_steps` if given. -> the subjects' final
    TrainStates. Inside a data-parallel group every rank holds every
    subject and steps it on its shard of the subject's global batch."""
    require_device(device)
    S = len(cfgs)
    cfg0 = cfgs[0]
    opt, stage = cfg0.opt, cfg0.model.train_stage
    grp = mesh.group()
    lead = grp is None or grp.rank == 0
    loggers = []
    for cfg in cfgs:
        if lead:
            os.makedirs(join(cfg.model.model_path, "log"), exist_ok=True)
            cfg.save(join(cfg.model.model_path, "cfg_args.json"))
        loggers.append(open_logger(cfg.model.model_path, lead))
    launches_before = dict(LAUNCHES)
    try:
        subjects, loaders, steps_per_epoch = build_subjects(cfgs, device)
        states = [s.state for s in subjects]
        model_paths = [cfg.model.model_path for cfg in cfgs]
        H, W = subjects[0].bundle.frames.image_hw()
        bg = (1.0, 1.0, 1.0) if cfg0.model.white_background else (0.0, 0.0, 0.0)

        epoch_start = 0
        if checkpoint_epochs:
            epoch_start = int(checkpoint_epochs[0])
            ckpt.load_stacked_checkpoint(model_paths, epoch_start, states)
            print(f"resumed {S} subjects from epoch {epoch_start} at iteration "
                  f"{states[0].iteration}")
        elif stage == 2:
            stage1 = {cfg.model.stage1_out_path for cfg in cfgs}
            print(f"warning: every subject boots stage 2 from the one stage-1 save "
                  f"{', '.join(sorted(stage1))}, as in the JAX multi-subject loop (ROADMAP F14)")
            for s, cfg in zip(subjects, cfgs):
                ckpt.stage_load(s.bundle.net, cfg.model.stage1_out_path)
        for s in subjects:
            mesh.replicate(s.bundle.net, grp)
        step = make_grid_step(subjects, opt, H, W, bg, raster_config(cfg0, train=True), grp,
                              train_stage=stage)

        first_iter = start_iter = epoch_start * steps_per_epoch
        t_start = time.time()
        done = False
        epoch = epoch_start
        for epoch in range(epoch_start + 1, opt.epochs + 1):
            w_rgl = adjust_loss_weights(opt.lambda_rgl, epoch, "decay", epoch_start, 20)
            pose_gate = pose_opt_gate_value(stage, epoch, opt)
            lpips_gate = lpips_gate_value(False, epoch, opt)
            for per_subject in zip(*loaders):
                feeds = [{k: v for k, v in b.items() if k not in DROP_KEYS} for b in per_subject]
                results = step(feeds, w_rgl, pose_gate, lpips_gate)
                first_iter += 1
                if first_iter == start_iter + 1:
                    # it/s leaves out the run's first step (kernel builds, warm-up)
                    if results[0][0]["total"].is_cuda:
                        torch.cuda.synchronize()
                    t_start = time.time()
                if first_iter % 10 == 0 or first_iter == start_iter + 1:
                    totals = np.array([float(terms["total"]) for terms, _ in results])
                    dt = time.time() - t_start
                    steps_done = first_iter - start_iter - 1
                    rate = f" ({steps_done / dt:.2f} it/s x {S} subjects)" if steps_done else ""
                    print(f"iter {first_iter} epoch {epoch} "
                          f"loss/subject {np.array2string(totals, precision=4)}{rate}")
                    for logger, (terms, _) in zip(loggers, results):
                        logger.log(first_iter, {k: float(v) for k, v in terms.items()})
                if lead and (first_iter - 1) % opt.log_iter == 0:
                    for cfg, (_, images) in zip(cfgs, results):
                        save_image_grid(join(cfg.model.model_path, "log",
                                             f"{first_iter:05d}_pred.png"),
                                        images.cpu().numpy())
                if max_steps is not None and first_iter >= max_steps:
                    done = True
                    break
            if lead and epoch > saving_epochs[0] and epoch % cfg0.model.save_epoch == 0:
                print(f"[Epoch {epoch}] saving {S} subject checkpoints")
                ckpt.save_stacked_checkpoint(model_paths, epoch, states)
            if done:
                break

        if lead:
            ckpt.save_stacked_checkpoint(model_paths, min(epoch, opt.epochs), states)
        # the whole run's launches (every subject, every rank) in each subject's log
        launches = mesh.sum_counts(launches_since(launches_before), grp)
        for logger in loggers:
            logger.log_event("kernel_launches", launches)
        return states
    finally:
        for logger in loggers:
            logger.close()
