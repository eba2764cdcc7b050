"""The yardstick's arithmetic: model FLOPs counted from a configuration's
shapes, and the published peaks of one NVIDIA H100 SXM (dense, no
sparsity, at its 700 W limit), which the share metrics divide by.

Model FLOPs count each multiply-add as 2 operations: the three 5 x 5
geometry convolutions on the F x F feature map, the stage-2 UNet pose
encoder on one F x F input posmap, and the ShapeDecoder's 14 dense layers
on the avatar's valid rows (padding rows, which the program also decodes,
are waste and not counted). The bilinear upsample, BatchNorm, the
activations, LBS, projection and the blend are left out. A training step
counts 3 x its forward (the forward, and the backward's two products).
"""

from __future__ import annotations

from benchmark.reference.net import dense_shapes, unet_shapes

PEAK_BF16_FLOPS = 989e12    # tensor cores, bf16 dense
PEAK_FP32_FLOPS = 67e12     # CUDA cores, f32
PEAK_HBM_BYTES = 3.35e12    # HBM3


def decoder_row_flops(cfg: dict) -> int:
    """Forward FLOPs of the ShapeDecoder on one row."""
    return sum(2 * i * o for i, o in dense_shapes(cfg["c_geom"] + 2, cfg["hsize"]))


def geometry_conv_flops(cfg: dict) -> int:
    F, C = cfg["inp_posmap_size"], cfg["c_geom"]
    return 3 * 2 * F * F * C * C * 25


def unet_flops(cfg: dict) -> int:
    """Forward FLOPs of the pose encoder on one input posmap (stage 2)."""
    if cfg["train_stage"] != 2:
        return 0
    F = cfg["inp_posmap_size"]
    downs, ups = unet_shapes(3, cfg["c_pose"], cfg["nf"])
    n = len(downs)
    total = sum(2 * (F >> (i + 1)) ** 2 * ci * co * 16 for i, (ci, co) in enumerate(downs))
    total += sum(2 * (F >> (n - i)) ** 2 * ci * co * 16 for i, (ci, co) in enumerate(ups))
    return total


def decode_flops(cfg: dict, num_valid: int) -> int:
    """Forward FLOPs of one decode (one frame's worth of rows)."""
    return geometry_conv_flops(cfg) + unet_flops(cfg) + decoder_row_flops(cfg) * num_valid


def train_step_flops(cfg: dict, num_valid: int) -> int:
    """One optimizer step: stage 1 decodes once, stage 2 once per frame."""
    decodes = 1 if cfg["train_stage"] == 1 else cfg["batch_size"]
    return 3 * decodes * decode_flops(cfg, num_valid)


def render_call_flops(cfg: dict, num_valid: int, frames: int) -> int:
    """One render call: stage 2 decodes every frame; stage 1 renders from
    its canonical cache and decodes nothing."""
    return frames * decode_flops(cfg, num_valid) if cfg["train_stage"] == 2 else 0
