"""Multi-subject training: S independent avatars trained side by side in
lockstep on one card (counterpart of gaussianavatar_tpu/parallel/
multi_subject.py).

The avatars share an architecture and body model but own everything else:
each subject has its own AvatarNet (parameters, BatchNorm statistics,
per-frame embeddings with its own row count), AvatarAssets (its betas and
canonical geometry), GT bank, TrainState and GroupOptimizer. The JAX
package stacks them along a leading subject axis and vmaps one fused step;
here every subject keeps its own `make_train_step`, and one multi-subject
step runs them in turn. That reproduces single-subject training of each
subject exactly and needs no padding of the embedding tables. Subjects
exchange nothing.

The constraints of the JAX package's stacked step are kept, with its
messages (`check_subjects`): one smpl_type, one pose dimensionality, one
UV atlas (valid-pixel count and query resolution), one image size.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from gaussianavatar_torch.engine.setup import AvatarBundle
from gaussianavatar_torch.engine.train_step import TrainState, make_train_step
from gaussianavatar_torch.ops.rasterize import RasterizeConfig


class Subject(NamedTuple):
    """One avatar of a multi-subject run."""

    bundle: AvatarBundle
    state: TrainState
    gt_bank: torch.Tensor                 # (n_frames, 3, H, W) uint8 on the device
    inp_bank: Optional[torch.Tensor] = None   # stage 2's input posmaps
    need_caps: Optional[torch.Tensor] = None  # its need table's caps (engine/need_table.py)


def check_subjects(cfgs: Sequence, bundles: Sequence[AvatarBundle]):
    """The JAX package's constraints on subjects trained together
    (multi_loop.build_subject_bundles, multi_subject.stack_assets)."""
    b0, c0 = bundles[0], cfgs[0]
    for b, c in zip(bundles[1:], cfgs[1:]):
        if c.model.smpl_type != c0.model.smpl_type:
            raise ValueError("subjects must share smpl_type")
        if b.frames.pose_data.shape[1] != b0.frames.pose_data.shape[1]:
            raise ValueError("subjects must share the pose dimensionality")
        if b.assets.num_valid != b0.assets.num_valid or b.assets.query_res != b0.assets.query_res:
            raise ValueError("subjects must share a UV atlas (query_posmap_size)")
    H, W = b0.frames.image_hw()
    for b in bundles[1:]:
        hw = b.frames.image_hw()
        if hw != (H, W):
            raise ValueError(f"subjects must share the image size ({hw} vs {(H, W)})")


def make_multi_subject_step(
    subjects: Sequence[Subject],
    opt_cfg,
    H: int,
    W: int,
    bg_color,
    raster_cfg: RasterizeConfig,
    train_stage: int = 1,
) -> Callable:
    """-> step(batches, w_rgl, pose_opt_gate, lpips_gate=0.0) -> [(terms,
    images)] per subject: one optimizer step of every subject, subject s on
    batches[s], in subject order. Each subject's step is its single-subject
    `make_train_step` (no LPIPS term, no AIAP graph, as the JAX grid step)."""
    steps = [
        make_train_step(s.bundle.net, s.bundle.body_model, s.bundle.assets, opt_cfg, H, W,
                        bg_color, raster_cfg, s.gt_bank, train_stage=train_stage,
                        inp_bank=s.inp_bank, need_caps=s.need_caps)
        for s in subjects
    ]

    def step(batches: Sequence[dict], w_rgl: float, pose_opt_gate: float,
             lpips_gate: float = 0.0) -> List[tuple]:
        if len(batches) != len(steps):
            raise ValueError(f"{len(batches)} batches for {len(steps)} subjects")
        return [one(s.state, b, w_rgl, pose_opt_gate, lpips_gate)
                for one, s, b in zip(steps, subjects, batches)]

    return step
