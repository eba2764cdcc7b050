"""The training loop (counterpart of gaussianavatar_tpu/engine/loop.py,
lean), stage 1 and stage 2: epochs over shuffled drop-last batches, the
regulariser decay (x0.85 every 20 epochs), the pose-optimization and LPIPS
epoch gates, dispatch groups of `steps_per_dispatch` steps, the loss and
it/s log (stdout and metrics.jsonl), the debug dumps (`log/NNNNN_pred.png`
and `_gt.png`, the batch's renders and GT side by side, and
`log/pred_NNNNN.ply`, the first frame's posed points in eval mode),
checkpoints (`net/iteration_N/net_torch.pt` and `train_torch.pt`) at the
save epochs and at the end, and resuming from one (`checkpoint_epochs`)
with the JAX loop's semantics.

The groups are the JAX loop's (`epoch_groups`): within an epoch the
batches are taken S at a time (S = `steps_per_dispatch`, 8 by default) and
a full group runs as one dispatch (engine/train_step.make_train_steps: on
the card one replay of a CUDA graph of the S steps); a group cut short by
the epoch's end or by `max_steps` runs as single steps. A group is logged,
with its last step's terms, when the iteration after it is within S past a
multiple of 10, or when it is the run's first; the dumps fire when a
multiple of `log_iter` (plus one) falls inside the group, with the last
step's renders. The it/s clock starts after the run's first group (kernel
builds and the graph's capture left out).

Stage 2 boots from a stage-1 save (`stage1_out_path`, through
`checkpoint.stage_load`) and keeps every training frame's input posmap on
the device beside the GT bank (or the one `--fixed_inp` posmap). As in the
JAX loop, `stage_load` runs after a resume, so a resumed stage-2 run takes
the decoder, the geometry features and the embeddings from stage 1 again
(`restore_state`, which says so when it happens).

With `--ragged 1 --auto_cascade 1` (which the JAX train CLIs and the
port's `train` turn on by default above 256 queries) the run keeps the JAX
loop's need table and adaptive footprint (engine/need_table.py): every frame's
per-tile row caps from the saturation probe, built before the first epoch
and rebuilt after it and at every save epoch, and the footprint M switched
between 9 and 4 tiles at those retunes, the step rebuilt for the new M.

Left out, because the port does not need them: the rest of the TPU
capacity machinery (chunk budgets, sampled retunes, cascade tiers) and
`device_prefetch` (the feeds are a few KB, copied before each dispatch).

Inside a data-parallel group (parallel/mesh.py; `train.py --dp N` starts
one) every rank holds the GT bank (and in stage 2 the posmap bank), draws
the same shuffle and steps on its shard of each global batch; the network
is broadcast from rank 0 after init or resume. A group's S steps run
eagerly there (its gloo collectives cannot be captured), with the same
group boundaries and log cadence. The iteration, the gates,
the regulariser decay and the learning-rate schedule follow the global
step, and it/s counts global steps, as in the JAX `train(..., dp)`. Rank 0
alone writes `cfg_args.json`, `metrics.jsonl`, the debug dumps (its shard
of the batch) and the checkpoints; every rank resumes from the same save.
At the end the run logs its kernel launches, summed over the ranks, as the
`kernel_launches` event (a spawned rank's counts are not visible to the
process that started it).

With `use_aiap` the run builds the AIAP neighbour graph once, on the host
(`host_knn`, k=5 over the valid canonical query points), as the JAX loop
does.
"""

from __future__ import annotations

import itertools
import os
import time
from os.path import join
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gaussianavatar_torch.config import Config
from gaussianavatar_torch.data.dataset import BatchLoader
from gaussianavatar_torch.engine import checkpoint as ckpt
from gaussianavatar_torch.engine import need_table
from gaussianavatar_torch.engine.inference import frame_gaussians, load_fixed_inp, require_device
from gaussianavatar_torch.engine.logging_utils import open_logger
from gaussianavatar_torch.engine.optim import build_optimizer
from gaussianavatar_torch.engine.setup import setup_avatar
from gaussianavatar_torch.engine.train_step import TrainState, make_train_step, make_train_steps
from gaussianavatar_torch.models.avatar import DEFAULT_INIT
from gaussianavatar_torch.ops.knn import host_knn
from gaussianavatar_torch.ops.lpips import lpips_status
from gaussianavatar_torch.ops.rasterize import raster_config
from gaussianavatar_torch.parallel import mesh
from gaussianavatar_torch.utils.cuda_build import LAUNCHES, launches_since
from gaussianavatar_torch.utils.obj_io import save_ply_points

# per-item keys the step does not read
DROP_KEYS = {"FovX", "FovY", "height", "width", "projection_matrix", "camera_center"}


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
    """The 0.2 * LPIPS term joins the loss after lpips_start_iter epochs
    (the reference's `if epoch > 30`)."""
    return float(lpips_active and epoch > opt.lpips_start_iter)


def restore_state(state: TrainState, mp, checkpoint_epochs: Sequence[int] = ()) -> int:
    """Resume `state` from `model_path/net/iteration_E` (E =
    checkpoint_epochs[0]) if asked, then, in stage 2, `stage_load` from
    `mp.stage1_out_path`, in the JAX loop's order (so a resumed stage-2 run
    takes pop, geo_feature and the embeddings from stage 1 again, ROADMAP
    F10; a line says so). -> the epoch training goes on from."""
    epoch_start = 0
    if checkpoint_epochs:
        epoch_start = int(checkpoint_epochs[0])
        ckpt.load_train_state(mp.model_path, epoch_start, state)
        print(f"resumed from epoch {epoch_start} at iteration {state.iteration}")
    if mp.train_stage == 2:
        if checkpoint_epochs:
            print(f"warning: resuming stage 2 from epoch {epoch_start}: pop, geo_feature and "
                  f"the embeddings come from stage 1 again ({mp.stage1_out_path}), as in the "
                  "JAX loop; the resumed decoder is replaced (ROADMAP F10)")
        ckpt.stage_load(state.net, mp.stage1_out_path)
        print(f"stage 2 boots from {mp.stage1_out_path}")
    return epoch_start


def input_posmap_bank(mp, dataset, device) -> torch.Tensor:
    """Stage 2's input posmaps on the device, (n_frames, 3, F, F) float32,
    gathered by pose_idx in the step; with `fixed_inp` the one canonical
    posmap at the input resolution, (1, 3, F, F)."""
    if mp.fixed_inp:
        bank = load_fixed_inp(mp)[None]
        print(f"fixed_inp: every frame takes the canonical posmap at {mp.inp_posmap_size}")
    else:
        bank = np.stack([dataset.inp_posmap(i) for i in range(len(dataset))])
    return torch.as_tensor(bank, device=device)


def build_gt_bank(dataset, device) -> torch.Tensor:
    """The GT bank: every training frame once on the device, (n_frames, 3,
    H, W) uint8, gathered by pose_idx in the step; from here the dataset
    serves cameras only."""
    gt_bank = torch.as_tensor(np.stack([dataset.frame_u8(i) for i in range(len(dataset))]),
                              device=device)
    dataset.drop_image_cache()
    H, W = gt_bank.shape[-2:]
    print(f"GT bank on {device}: {len(dataset)} frames of {H}x{W}, "
          f"{gt_bank.numel() / 2**20:.0f} MB uint8")
    return gt_bank


class Group(NamedTuple):
    """One dispatch group of an epoch."""
    size: int        # steps in the group
    dispatch: bool   # one S-step dispatch; else `size` single steps
    end: int         # the iteration after the group
    log: bool        # a metrics line with the group's last terms
    dump: bool       # the debug dumps, with the group's last renders


def epoch_groups(n_batches: int, spd: int, first_iter: int, run_start: int, log_iter: int,
                 max_steps: Optional[int] = None) -> List[Group]:
    """The groups of one epoch of `n_batches` batches, starting after
    iteration `first_iter`, in a run that started after `run_start`: the
    JAX loop's rule (gaussianavatar_tpu/engine/loop.py:490-546). A group
    takes S = `spd` batches, or fewer so that `max_steps` is exact (at least
    one); only a group of S is a dispatch. It is logged when its end lies
    within S past a multiple of 10 (`first_iter % 10 < spd`) or within S of
    the run's start, and dumps when its end minus one lies within S past a
    multiple of `log_iter`. The epoch ends early once `max_steps` is
    reached."""
    spd = max(int(spd), 1)
    groups, left = [], n_batches
    while left > 0:
        target = spd
        if max_steps is not None:
            target = max(min(target, max_steps - first_iter), 1)
        size = min(target, left)
        left -= size
        first_iter += size
        groups.append(Group(size, spd > 1 and size == spd, first_iter,
                            first_iter % 10 < spd or first_iter <= run_start + spd,
                            (first_iter - 1) % log_iter < spd))
        if max_steps is not None and first_iter >= max_steps:
            break
    return groups


def save_image_grid(path: str, images: np.ndarray):
    """(B, 3, H, W) in [0,1] -> horizontal grid PNG."""
    from PIL import Image

    arr = np.clip(np.asarray(images), 0, 1)
    arr = (arr.transpose(0, 2, 3, 1) * 255).astype(np.uint8)
    grid = np.concatenate(list(arr), axis=1)
    Image.fromarray(grid).save(path)


def debug_points(bundle, feed: dict, inp_bank: Optional[torch.Tensor]) -> np.ndarray:
    """The first frame of a training batch, posed from the network in eval
    mode at the inference iteration -> its valid points (Nv, 3) (the JAX
    loop's `make_debug_points_fn`)."""
    batch = dict(feed)
    if inp_bank is not None:
        idx = torch.as_tensor(feed["pose_idx"], device=inp_bank.device).long()
        batch["inp_pos_map"] = inp_bank[idx * 0 if inp_bank.shape[0] == 1 else idx]
    mode = bundle.net.training
    bundle.net.eval()
    try:
        world = frame_gaussians(bundle, batch)[0]
    finally:
        bundle.net.train(mode)
    return world[0, :bundle.assets.num_valid].cpu().numpy()


def train(
    cfg: Config,
    saving_epochs: Sequence[int],
    device: str = "cuda",
    max_steps: Optional[int] = None,
    lpips_note: Optional[str] = None,
    checkpoint_epochs: Sequence[int] = (),
    lpips_fn=None,
    init: str = DEFAULT_INIT,
) -> TrainState:
    """Train an avatar (stage `cfg.model.train_stage`) from `cfg.model.source_path` into
    `cfg.model.model_path`; stops once the iteration reaches `max_steps` if
    given. Returns the final state.

    With `checkpoint_epochs` [E, ...] the run resumes from
    `model_path/net/iteration_E` (network, optimizer counts and moments,
    iteration) at epoch E + 1, as the JAX loop does: the regulariser decay
    counts from E (the JAX loop's `adjust_loss_weights(..., epoch_start)`),
    the shuffle starts again from its seed, and the learning-rate schedule
    and the optimizer's counts go on from the restored ones.

    `lpips_fn` (ops/lpips.LPIPS on `device`) adds the gated LPIPS term; the
    `lpips` event of metrics.jsonl reads "active" with it, else
    `lpips_note` if given, else `lpips_status` of the project. `init` is
    the network's initialisation (engine/setup.setup_avatar)."""
    require_device(device)
    mp, opt = cfg.model, cfg.opt
    grp = mesh.group()
    lead = grp is None or grp.rank == 0
    if lead:
        os.makedirs(join(mp.model_path, "log"), exist_ok=True)
        cfg.save(join(mp.model_path, "cfg_args.json"))
    logger = open_logger(mp.model_path, lead)
    launches_before = dict(LAUNCHES)
    try:
        # "active" only when the term is in the loss; a caller's note (e.g.
        # "disabled (--no_lpips)") wins over probing the files again
        logger.log_event("lpips", "active" if lpips_fn is not None
                         else (lpips_note or lpips_status(mp.project_path)))

        bundle = setup_avatar(cfg, device=device, train=True, init=init)
        dataset, net = bundle.frames, bundle.net
        loader = BatchLoader(dataset, mp.batch_size)
        steps_per_epoch = len(loader)
        H, W = dataset.image_hw()
        bg = (1.0, 1.0, 1.0) if mp.white_background else (0.0, 0.0, 0.0)

        gt_bank = build_gt_bank(dataset, device)
        inp_bank = input_posmap_bank(mp, dataset, device) if mp.train_stage == 2 else None

        aiap_nn = None
        if opt.use_aiap:
            pts = bundle.assets.query_points[:bundle.assets.num_valid].cpu().numpy()
            aiap_nn = torch.as_tensor(host_knn(pts, k=5), device=device)
            print(f"AIAP regularizer on: {pts.shape[0]} points, k=5")

        net.train()
        state = TrainState(net, build_optimizer(net, opt, steps_per_epoch, mp.train_stage))
        epoch_start = restore_state(state, mp, checkpoint_epochs)
        mesh.replicate(net, grp)
        raster_cfg = raster_config(cfg, train=True)
        need = None
        if need_table.enabled(cfg):
            need = need_table.NeedTable(cfg, bundle, dataset, raster_cfg, H, W,
                                        drop=DROP_KEYS, inp_bank=inp_bank)
            need_table.update([need], [logger])
        spd = max(int(opt.steps_per_dispatch), 1)

        def build_steps():
            """The single step and the S-step dispatch at the current footprint."""
            args = (net, bundle.body_model, bundle.assets, opt, H, W, bg,
                    raster_cfg if need is None else need.config(), gt_bank)
            kw = dict(train_stage=mp.train_stage, lpips_fn=lpips_fn, aiap_nn=aiap_nn,
                      inp_bank=inp_bank, need_caps=None if need is None else need.caps)
            return (make_train_step(*args, **kw),
                    make_train_steps(*args, steps=spd, **kw) if spd > 1 else None)

        step, steps = build_steps()
        if steps is not None and grp is not None:
            print(f"--dp: each group of {spd} steps runs eagerly, one step after another "
                  "(the ranks' gloo collectives cannot be captured in a CUDA graph)")

        run_start = first_iter = clock_iter = state.iteration
        ema_loss = 0.0
        t_start = time.time()
        done = False
        epoch = epoch_start
        for epoch in range(epoch_start + 1, opt.epochs + 1):
            w_rgl = adjust_loss_weights(opt.lambda_rgl, epoch, "decay", epoch_start, 20)
            pose_gate = pose_opt_gate_value(mp.train_stage, epoch, opt)
            lpips_gate = lpips_gate_value(lpips_fn is not None, epoch, opt)
            batches = iter(loader)
            for group in epoch_groups(steps_per_epoch, spd, first_iter, run_start,
                                      opt.log_iter, max_steps):
                feeds = [mesh.shard_batch({k: v for k, v in batch.items() if k not in DROP_KEYS},
                                          grp) for batch in itertools.islice(batches, group.size)]
                if group.dispatch:
                    terms, images = steps(state, feeds, w_rgl, pose_gate, lpips_gate)
                    terms = {k: v[-1] for k, v in terms.items()}
                else:
                    for feed in feeds:
                        terms, images = step(state, feed, w_rgl, pose_gate, lpips_gate)
                first_iter = state.iteration
                if first_iter <= run_start + spd:
                    # it/s leaves out the run's first group (kernel builds,
                    # allocator warm-up, the graph's capture)
                    if terms["total"].is_cuda:
                        torch.cuda.synchronize()
                    t_start, clock_iter = time.time(), first_iter
                if group.log:
                    loss = float(terms["total"])
                    ema_loss = 0.4 * loss + 0.6 * ema_loss if ema_loss else loss
                    dt = time.time() - t_start
                    n = first_iter - clock_iter
                    rate = f" ({n / dt:.2f} it/s)" if n else ""
                    print(f"iter {first_iter} epoch {epoch} loss {ema_loss:.5f}{rate}")
                    logger.log(first_iter, {**{k: float(v) for k, v in terms.items()},
                                            "iter_time": dt / max(n, 1), "w_rgl": w_rgl})
                if lead and group.dump:
                    log_dir = join(mp.model_path, "log")
                    save_image_grid(join(log_dir, f"{first_iter:05d}_pred.png"),
                                    images.cpu().numpy())
                    idx = torch.as_tensor(feeds[-1]["pose_idx"], device=gt_bank.device).long()
                    save_image_grid(join(log_dir, f"{first_iter:05d}_gt.png"),
                                    (gt_bank[idx].float() / 255.0).cpu().numpy())
                    save_ply_points(join(log_dir, f"pred_{first_iter:05d}.ply"),
                                    debug_points(bundle, feeds[-1], inp_bank))
                if max_steps is not None and first_iter >= max_steps:
                    done = True
            if need is not None and not done and (epoch == epoch_start + 1
                                                  or epoch % mp.save_epoch == 0):
                # opacities, hence the needed depths, move during training
                if need_table.update([need], [logger], epoch):
                    step, steps = build_steps()
            if lead and epoch > saving_epochs[0] and epoch % mp.save_epoch == 0:
                print(f"[Epoch {epoch}] saving model")
                ckpt.save_train_state(mp.model_path, epoch, state)
            if done:
                break

        if lead:
            ckpt.save_train_state(mp.model_path, min(epoch, opt.epochs), state)
        if need is not None:
            # the probes' H-fwd launches are among the kernel launches below
            logger.log_event("need_table_probes", need.probes)
        logger.log_event("kernel_launches", mesh.sum_counts(launches_since(launches_before), grp))
        return state
    finally:
        logger.close()
