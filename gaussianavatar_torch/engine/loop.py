"""The stage-1 training loop (counterpart of gaussianavatar_tpu/engine/
loop.py, lean): epochs over shuffled drop-last batches, the regulariser
decay (x0.85 every 20 epochs), the pose-optimization and LPIPS epoch gates,
the loss and it/s log every 10 steps (stdout and metrics.jsonl), and
checkpoints (`net/iteration_N/net_torch.pt`) at the save epochs and at the
end, which the port's render_novel_pose reads.

Left out, because the port does not need them: the TPU capacity machinery
(need tables and their retunes, chunk budgets, cascade tiers, footprint
adaptation; the port's blend walks every tile's whole range),
`steps_per_dispatch` scans and `device_prefetch` (dispatch-latency work for
the TPU's host link), and `--dp`. Left for later slices: stage 2, resume
from `--checkpoint_epochs`, LPIPS and AIAP, and the periodic PNG/PLY debug
dumps.
"""

from __future__ import annotations

import time
from os.path import join
from typing import Optional, Sequence

import numpy as np
import torch

from gaussianavatar_torch.config import Config
from gaussianavatar_torch.data.dataset import BatchLoader
from gaussianavatar_torch.engine import checkpoint as ckpt
from gaussianavatar_torch.engine.inference import require_device
from gaussianavatar_torch.engine.logging_utils import MetricsLogger
from gaussianavatar_torch.engine.optim import build_optimizer
from gaussianavatar_torch.engine.setup import setup_avatar
from gaussianavatar_torch.engine.train_step import TrainState, make_train_step
from gaussianavatar_torch.ops.rasterize import raster_config

# per-item keys the step does not read
_DROP_KEYS = {"FovX", "FovY", "height", "width", "projection_matrix", "camera_center"}


def adjust_loss_weights(init_weight, current_epoch, mode="decay", start=0, every=20):
    """The reference's utils/general_utils.py:261-280."""
    if current_epoch < start:
        return init_weight * (1e-6 if mode == "rise" else 1.0)
    if every == 0:
        return init_weight
    factor = 1.05 if mode == "rise" else 0.85
    return init_weight * factor ** ((current_epoch - start) // every)


def pose_opt_gate_value(train_stage: int, epoch: int, opt) -> float:
    """Stage-1 pose refinement starts after pose_op_start_iter EPOCHS (the
    reference compares the iteration setting against the epoch)."""
    return float(train_stage == 1 and epoch > opt.pose_op_start_iter)


def lpips_gate_value(lpips_active: bool, epoch: int, opt) -> float:
    """The LPIPS term joins after lpips_start_iter epochs; 0 while LPIPS is
    not ported."""
    return float(lpips_active and epoch > opt.lpips_start_iter)


def train(
    cfg: Config,
    saving_epochs: Sequence[int],
    device: str = "cuda",
    max_steps: Optional[int] = None,
    lpips_note: Optional[str] = None,
) -> TrainState:
    """Train a stage-1 avatar from `cfg.model.source_path` into
    `cfg.model.model_path`; stops after `max_steps` optimizer steps if
    given. Returns the final state."""
    require_device(device)
    mp, opt = cfg.model, cfg.opt
    if mp.train_stage != 1:
        raise NotImplementedError("stage-2 training is not ported yet (a later slice of the port)")
    cfg.save(join(mp.model_path, "cfg_args.json"))
    logger = MetricsLogger(mp.model_path)
    try:
        logger.log_event("lpips", lpips_note or "not ported yet: training runs as with --no_lpips")

        bundle = setup_avatar(cfg, device=device, train=True)
        dataset, net = bundle.frames, bundle.net
        loader = BatchLoader(dataset, mp.batch_size)
        steps_per_epoch = len(loader)
        H, W = dataset.image_hw()
        bg = (1.0, 1.0, 1.0) if mp.white_background else (0.0, 0.0, 0.0)

        # the GT bank: every frame once on the device as uint8, gathered by
        # pose_idx in the step; from here the dataset serves cameras only
        gt_bank = torch.as_tensor(np.stack([dataset.frame_u8(i) for i in range(len(dataset))]),
                                  device=device)
        dataset.drop_image_cache()
        print(f"GT bank on {device}: {len(dataset)} frames of {H}x{W}, "
              f"{gt_bank.numel() / 2**20:.0f} MB uint8")

        net.train()
        state = TrainState(net, build_optimizer(net, opt, steps_per_epoch, mp.train_stage))
        step = make_train_step(net, bundle.body_model, bundle.assets, opt, H, W, bg,
                               raster_config(cfg, train=True), gt_bank,
                               train_stage=mp.train_stage, use_aiap=bool(opt.use_aiap))

        ema_loss = 0.0
        t_start = time.time()
        done = False
        epoch = 0
        for epoch in range(1, opt.epochs + 1):
            w_rgl = adjust_loss_weights(opt.lambda_rgl, epoch, "decay", 0, 20)
            pose_gate = pose_opt_gate_value(mp.train_stage, epoch, opt)
            lpips_gate = lpips_gate_value(False, epoch, opt)
            for batch in loader:
                feed = {k: v for k, v in batch.items() if k not in _DROP_KEYS}
                terms, _ = step(state, feed, w_rgl, pose_gate, lpips_gate)
                it = state.iteration
                if it == 1:
                    # it/s leaves out the first step (kernel builds, allocator warm-up)
                    if terms["total"].is_cuda:
                        torch.cuda.synchronize()
                    t_start = time.time()
                if it % 10 == 0 or it == 1:
                    loss = float(terms["total"])
                    ema_loss = 0.4 * loss + 0.6 * ema_loss if ema_loss else loss
                    dt = time.time() - t_start
                    rate = f" ({(it - 1) / dt:.2f} it/s)" if it > 1 else ""
                    print(f"iter {it} epoch {epoch} loss {ema_loss:.5f}{rate}")
                    logger.log(it, {**{k: float(v) for k, v in terms.items()},
                                    "iter_time": dt / max(it, 1)})
                if max_steps is not None and it >= max_steps:
                    done = True
                    break
            if epoch > saving_epochs[0] and epoch % mp.save_epoch == 0:
                print(f"[Epoch {epoch}] saving model")
                ckpt.save_checkpoint(mp.model_path, epoch, net)
            if done:
                break

        ckpt.save_checkpoint(mp.model_path, min(epoch, opt.epochs), net)
        return state
    finally:
        logger.close()
