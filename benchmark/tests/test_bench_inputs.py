"""The traffic generators and the yardstick's arithmetic."""

import numpy as np
import pytest
import torch

from benchmark.harness import flops, inputs
from benchmark.harness.cells import _render_batches
from benchmark.tests._tiny import load, tiny


@pytest.mark.parametrize("cell", ["s1-train", "s2-train", "s2-render"])
def test_same_seed_same_inputs(cell):
    cfg, mix = tiny(cell)
    a = inputs.make(cfg, mix, 2 ** 31 + 77, "cpu")
    b = inputs.make(cfg, mix, 2 ** 31 + 77, "cpu")
    c = inputs.make(cfg, mix, 5, "cpu")
    for k in a.weights:
        assert torch.equal(a.weights[k], b.weights[k]), k
    assert any(not torch.equal(a.weights[k], c.weights[k]) for k in a.weights)
    # every seed: the same poses, frames and posmaps, in another order
    assert np.array_equal(a.pose, c.pose) and np.array_equal(a.transl, c.transl)
    if mix["kind"] == "train":
        assert torch.equal(a.gt, b.gt) and torch.equal(a.gt, c.gt)
        assert a.gt.dtype == torch.uint8 and a.gt.shape == (8, 3, 64, 64)
        assert int(a.gt.min()) < 200 and int(a.gt.max()) == 255   # the body on white
    if cfg["train_stage"] == 2:
        assert torch.equal(a.posmaps, c.posmaps)


def test_render_calls_follow_the_seed():
    cfg, mix = tiny("s2-render")
    x = inputs.make(cfg, mix, 7, "cpu")
    n_calls = mix["frames"] // mix["batch"]
    first = lambda seed: [c for c, _ in zip(_render_batches(mix, x, seed), range(n_calls))]
    a, b, c = first(7), first(7), first(8)
    assert all(np.array_equal(p[0], q[0]) for p, q in zip(a, b))
    for idx, batch in a:
        assert batch["inp_pos_map"].shape == (4, 3, 32, 32)
        assert np.array_equal(batch["pose_data"], x.pose[idx])
        assert np.array_equal(batch["inp_pos_map"], x.posmaps[idx].numpy())
    # any seed: one pass over the pose sequence takes every pose once, in
    # calls of consecutive poses, from a start the seed draws
    for calls in (a, c):
        seen = np.concatenate([i for i, _ in calls])
        assert sorted(seen.tolist()) == list(range(mix["frames"]))


def test_decoder_flops_by_hand():
    cfg = load("configs/ga-smpl-s1.json")
    # 66 -> 128, 3 x 128 -> 128, 194 -> 128, 2 x 128 -> 128, 128 -> 3,
    # 2 x 128 -> 128, 128 -> 1, 2 x 128 -> 128, 128 -> 3 multiply-adds, x 2
    macs = (66 * 128 + 3 * 128 * 128 + 194 * 128 + 2 * 128 * 128 + 128 * 3
            + 2 * 128 * 128 + 128 + 2 * 128 * 128 + 128 * 3)
    assert flops.decoder_row_flops(cfg) == 2 * macs == 363_264
    assert flops.geometry_conv_flops(cfg) == 3 * 2 * 128 * 128 * 64 * 64 * 25
    assert flops.unet_flops(cfg) == 0
    per_decode = 3 * 2 * 128 * 128 * 64 * 64 * 25 + 363_264 * 222_784
    assert flops.train_step_flops(cfg, 222_784) == 3 * per_decode
    assert flops.render_call_flops(cfg, 222_784, 4) == 0


def test_stage2_flops_by_hand():
    cfg = load("configs/ga-smpl-s2.json")
    # UNet5DS, nf 32: 4x4 stride-2 convs 3-32-64-128-256-256 down to 4^2,
    # transposed convs 256-256, 512-128, 256-64, 128-32, 64-64 back up
    downs = [(64, 3, 32), (32, 32, 64), (16, 64, 128), (8, 128, 256), (4, 256, 256)]
    ups = [(4, 256, 256), (8, 512, 128), (16, 256, 64), (32, 128, 32), (64, 64, 64)]
    unet = sum(2 * s * s * a * b * 16 for s, a, b in downs + ups)
    assert flops.unet_flops(cfg) == unet
    per_decode = 3 * 2 * 128 * 128 * 64 * 64 * 25 + unet + 363_264 * 222_784
    assert flops.train_step_flops(cfg, 222_784) == 3 * 2 * per_decode
    assert flops.render_call_flops(cfg, 222_784, 4) == 4 * per_decode


def test_roofline_bounds_by_hand():
    from benchmark.run import BENCH
    import importlib.util
    import os

    def mod(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(BENCH, "metrics",
                                                                         name + ".py"))
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        return m

    w = {"contributing": 10_000_000, "gaussians": 445_568, "pixels": 524_288}
    bwd, fwd = mod("hbwd_roofline"), mod("hfwd_roofline")
    assert bwd.bound_s(w) == pytest.approx(max((445_568 * 72 + 524_288 * 24) / 3.35e12,
                                               10_000_000 * 74 / 67e12))
    assert fwd.bound_s(w) == pytest.approx(max((445_568 * 36 + 524_288 * 16) / 3.35e12,
                                               10_000_000 * 26 / 67e12))
    # few pairs: the bytes bound it
    w0 = dict(w, contributing=1)
    assert fwd.bound_s(w0) == pytest.approx((445_568 * 36 + 524_288 * 16) / 3.35e12)
