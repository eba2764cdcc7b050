"""Subjects x frame data parallelism (counterpart of
gaussianavatar_tpu/parallel/grid.py): S avatars, each trained data-parallel
over `dp` ranks.

Each of the dp ranks (parallel/mesh.py) holds all S subjects and steps
every subject on its shard of that subject's global batch; each subject's
gradients are all-reduced over the ranks inside its own train step, and its
BatchNorm statistics are global as in single-subject `--dp` training.

This differs from the JAX package on purpose. Its `make_grid_mesh` asks
for S x dp devices, one mesh row per subject. On a card that holds every
subject the subject axis needs no device of its own, because subjects
exchange nothing (parallel/multi_subject.py), so the grid here is dp ranks,
whatever S. Placing subjects on separate cards waits for a multi-card cell.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from gaussianavatar_torch.ops.rasterize import RasterizeConfig
from gaussianavatar_torch.parallel.mesh import DataGroup, shard_batch
from gaussianavatar_torch.parallel.multi_subject import Subject, make_multi_subject_step


def make_grid_step(
    subjects: Sequence[Subject],
    opt_cfg,
    H: int,
    W: int,
    bg_color,
    raster_cfg: RasterizeConfig,
    grp: Optional[DataGroup],
    train_stage: int = 1,
) -> Callable:
    """-> step(global_batches, w_rgl, pose_opt_gate, lpips_gate=0.0) ->
    [(terms, images)] per subject: every subject stepped on this rank's
    shard of its global batch (the whole batch without a group); terms are
    the global batch's, images this rank's shard."""
    multi = make_multi_subject_step(subjects, opt_cfg, H, W, bg_color, raster_cfg,
                                    train_stage=train_stage)

    def step(global_batches: Sequence[dict], w_rgl: float, pose_opt_gate: float,
             lpips_gate: float = 0.0):
        return multi([shard_batch(b, grp) for b in global_batches], w_rgl, pose_opt_gate,
                     lpips_gate)

    return step
