"""Where the tile-blend kernels' time goes on the main paths' batches, on one card.

Records one render batch of chip_smoke.py's render (4 poses of the
canonical-width avatar at 1024^2) and times H-fwd on it with every tile's
rows capped at q, caps = min(count, q), for a few q. Then trains
chip_smoke.py's stage-1 configuration (8 synthetic frames of 512^2
from the port's writer, canonical widths, B=2, 32px tiles, M=9) for 30
steps through `gaussianavatar_torch.train.main`, keeps the last step's
inputs of H-fwd (`blend_tiles`) and H-bwd (`blend_tiles_bwd`), and then:

  1. times H-fwd on that batch beside its bound (chip_smoke._blend_bound);
  2. times H-fwd and H-bwd with every tile's rows capped at q, caps =
     min(count, q), for a few q: how much of their time the deepest tiles'
     serial walk sets;
  3. counts the (row, pixel) pairs H-bwd would walk if the walk ended at
     the deepest n_contrib of the whole tile (H-bwd's first design), of each
     16x16 quadrant, of each warp (32x1 pixel rows of the tile, 16x2
     strips or 8x4 patches of a quadrant, or a quadrant's pixels taken 32
     at a time by depth) and of each pixel, with the longest walk of one
     unit (the serial depth one block or warp must cover);
  4. times both kernels on the deepest tile alone (every other tile capped
     at 0), per row walked, and with no rows at all (the wrappers' cost).
For both batches it also counts the (row, 16x16 quadrant) pairs that the
kernels' per-row bound (csrc/blend_common.cuh `row_reaches`, here in
double on the whole quadrant) proves cut at every pixel.

    python3 scripts/torch_blend_probe.py
"""

import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CAPS = (256, 512, 1024, 2048, 4096, None)


def record_training_batch(work):
    """30 training steps; the last step's blend_tiles and blend_tiles_bwd
    arguments (detached)."""
    from gaussianavatar_torch import train as train_cli
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.ops import rasterize_tile

    data, out = os.path.join(work, "data"), os.path.join(work, "out")
    write_synthetic_dataset(data, n_train=8, n_test=1, image_size=512, device="cuda")
    real_fwd, real_bwd = rasterize_tile.blend_tiles, rasterize_tile.blend_tiles_bwd
    rec = {}

    def fwd(*a, **kw):
        rec["fwd"] = a
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        rec["bwd"] = a
        return real_bwd(*a, **kw)

    try:
        rasterize_tile.blend_tiles, rasterize_tile.blend_tiles_bwd = fwd, bwd
        train_cli.main(["-s", data, "-m", out, "--train_stage", "1", "--dataset_type",
                        "synthetic", "--max_steps", "30", "--pose_op_start_iter", "0",
                        "--no_lpips", "--quiet"])
        torch.cuda.synchronize()
    finally:
        rasterize_tile.blend_tiles, rasterize_tile.blend_tiles_bwd = real_fwd, real_bwd
    detach = lambda args: tuple(a.detach() if torch.is_tensor(a) else a for a in args)
    return detach(rec["fwd"][:6]), detach(rec["bwd"][:10])


def record_render_batch():
    """One render batch of chip_smoke.py's main path (4 poses of the
    canonical-width avatar at 1024^2): H-fwd's arguments (detached)."""
    from chip_smoke import make_slice

    from gaussianavatar_torch.ops import rasterize_tile

    s = make_slice("cuda")
    real, rec = rasterize_tile.blend_tiles, {}

    def recording(*a, **kw):
        rec["args"] = a
        return real(*a, **kw)

    try:
        rasterize_tile.blend_tiles = recording
        s.render(s.batch_for(0), s.iteration)
    finally:
        rasterize_tile.blend_tiles = real
    return tuple(a.detach() if torch.is_tensor(a) else a for a in rec["args"][:6])


def walk_units(offsets, ncon, ts):
    """(row, pixel) pairs walked and the longest walk, with the walk ending
    at the deepest n_contrib of each unit of pixels."""
    G = ncon.shape[0]
    count = (offsets[1:] - offsets[:-1]).long()
    nc = ncon.long().view(G, ts, ts)
    h = ts // 2
    quads = nc.view(G, 2, h, 2, h).permute(0, 1, 3, 2, 4).reshape(G, 4, h * h)
    units = {
        "tile (32x32)": (nc.amax((1, 2))[:, None], ts * ts),
        "quadrant (16x16)": (quads.amax(2), h * h),
        "warp, tile row (32x1)": (nc.amax(2), ts),
        "warp, quadrant strip (16x2)": (
            nc.view(G, 2, h // 2, 2, 2, h).amax((3, 5)).reshape(G, -1), 2 * h),
        "warp, 8x4 block": (nc.view(G, ts // 4, 4, ts // 8, 8).amax((2, 4)).reshape(G, -1), 32),
        # the 32 deepest pixels of a quadrant in one warp, the next 32 in the next, ...
        "warp, quadrant by depth": (
            quads.sort(dim=2, descending=True).values[..., ::32].reshape(G, -1), 32),
        "pixel": (nc.reshape(G, -1), 1),
    }
    out = {}
    for name, (m, px) in units.items():
        ends = torch.minimum(count[:, None], m)
        out[name] = (int(ends.sum()) * px, int(ends.max()), int(ends.numel()))
    return out


def quadrant_reach(packed, sorted_vals, offsets, txn, ts, n_tiles):
    """Of the (binned row, 16x16 quadrant of its tile) pairs, how many a
    per-row bound proves cut at every pixel of the quadrant: the power at a
    pixel is at most -lambda_min |d|^2 / 2 (lambda_min the conic's smaller
    eigenvalue, |d| the distance from the mean to the quadrant); where that,
    plus 2^-20 of the largest |term| as the float error of the per-pixel
    power, lies below the alpha pre-test's threshold, no pixel of the
    quadrant passes. -> (certified, total)."""
    count = (offsets[1:] - offsets[:-1]).long()
    dev = offsets.device
    tile = torch.repeat_interleave(torch.arange(count.shape[0], device=dev), count)
    rows = packed[sorted_vals[:int(offsets[-1])].long()].double()
    mx, my, ca, cb, cc = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4]
    op = torch.where(rows[:, 9] > 0, rows[:, 8], torch.zeros_like(rows[:, 8]))
    cut = torch.log((1.0 / 255.0) / op) - 0.01
    det = ca * cc - cb * cb
    lmin = det / ((ca + cc) / 2 + torch.sqrt(((ca - cc) / 2) ** 2 + cb * cb))
    local = tile % n_tiles
    h = ts // 2
    certified = 0
    for qy in range(2):
        for qx in range(2):
            x0 = ((local % txn) * ts + qx * h).double()
            y0 = ((local // txn) * ts + qy * h).double()
            x1, y1 = x0 + h - 1, y0 + h - 1
            near = (torch.clamp_min(x0 - mx, 0) + torch.clamp_min(mx - x1, 0)) ** 2 \
                + (torch.clamp_min(y0 - my, 0) + torch.clamp_min(my - y1, 0)) ** 2
            far = torch.maximum((x0 - mx).abs(), (x1 - mx).abs()) ** 2 \
                + torch.maximum((y0 - my).abs(), (y1 - my).abs()) ** 2
            err = 2.0**-20 * (ca.abs() + cc.abs() + cb.abs()) * far
            certified += int(((det > 0) & (ca > 0) & (-0.5 * lmin * near + err < cut)).sum())
    return certified, 4 * rows.shape[0]


def main():
    if not torch.cuda.is_available():
        print("torch_blend_probe: needs CUDA", file=sys.stderr)
        return 2
    from chip_smoke import _blend_bound, _time_ms

    from gaussianavatar_torch.ops.rasterize_tile import blend_tiles, blend_tiles_bwd

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    render_args = record_render_batch()
    rcount = (render_args[2][1:] - render_args[2][:-1]).long()
    cert, total = quadrant_reach(*render_args)
    print(f"render batch: {rcount.shape[0]} tiles, {int(rcount.sum())} binned pairs, per tile max "
          f"{int(rcount.max())} / mean {float(rcount.float().mean()):.1f}; (row, quadrant) pairs "
          f"proven cut at every pixel: {cert} of {total} ({100 * cert / total:.1f}%)")
    for q in CAPS:
        caps = None if q is None else torch.clamp_max(rcount, q).int()
        print(f"H-fwd, render batch, caps=min(count, {q}): "
              f"{_time_ms(lambda: blend_tiles(*render_args, caps=caps), reps=20):.4f} ms")
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        fwd_args, bwd_args = record_training_batch(work)
    packed, sorted_vals, offsets, txn, ts, n_tiles = fwd_args
    count = (offsets[1:] - offsets[:-1]).long()
    print(f"training batch: {offsets.shape[0] - 1} tiles of {ts}x{ts}, {int(offsets[-1])} binned "
          f"pairs, per tile max {int(count.max())} / mean {float(count.float().mean()):.1f}")
    cert, total = quadrant_reach(*fwd_args)
    print(f"(row, quadrant) pairs proven cut at every pixel: {cert} of {total} "
          f"({100 * cert / total:.1f}%)")

    ms = _time_ms(lambda: blend_tiles(*fwd_args), reps=20)
    bound = _blend_bound(fwd_args, None)
    print(f"H-fwd on the training batch: {ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); walk {bound['walk']}")
    for q in CAPS:
        caps = None if q is None else torch.clamp_max(count, q).int()
        print(f"H-fwd caps=min(count, {q}): "
              f"{_time_ms(lambda: blend_tiles(*fwd_args, caps=caps), reps=20):.4f} ms")

    ncon = bwd_args[7]
    print(f"H-bwd deepest contributor {int(ncon.max())}")
    for q in CAPS:
        caps = None if q is None else torch.clamp_max(count, q).int()
        ms = _time_ms(lambda: blend_tiles_bwd(*bwd_args, caps=caps), reps=20)
        walked = int(torch.minimum(count if caps is None else caps.long(),
                                   ncon.amax(1).long()).sum()) * ts * ts
        print(f"H-bwd caps=min(count, {q}): {ms:.4f} ms, {walked} (row, pixel) pairs walked")

    print("H-bwd (row, pixel) pairs walked with the walk ending per unit "
          "[pairs, longest walk in rows, units]:")
    for name, (pairs, longest, n) in walk_units(offsets, ncon, ts).items():
        print(f"  {name:28s} {pairs:12d} {longest:6d} {n:7d}")

    # the deepest tile alone (every other tile capped at 0): the serial
    # depth one block (H-fwd) or one tile's blocks (H-bwd) walk, per row
    deep = int(count.argmax())
    alone = torch.where(torch.arange(count.shape[0], device=count.device) == deep, count,
                        torch.zeros_like(count)).int()
    rows = int(count[deep])
    fwd_ms = _time_ms(lambda: blend_tiles(*fwd_args, caps=alone), reps=20)
    bwd_ms = _time_ms(lambda: blend_tiles_bwd(*bwd_args, caps=alone), reps=20)
    bwd_rows = int(torch.minimum(count[deep], ncon[deep].amax().long()))
    print(f"the deepest tile alone ({rows} rows): H-fwd {fwd_ms:.4f} ms "
          f"({fwd_ms * 1e6 / rows:.1f} ns per row), H-bwd {bwd_ms:.4f} ms over its "
          f"{bwd_rows} rows below the deepest contributor ({bwd_ms * 1e6 / max(bwd_rows, 1):.1f} "
          "ns per row)")
    empty = torch.zeros_like(alone)
    print(f"no rows at all: H-fwd {_time_ms(lambda: blend_tiles(*fwd_args, caps=empty), 20):.4f} "
          f"ms, H-bwd {_time_ms(lambda: blend_tiles_bwd(*bwd_args, caps=empty), 20):.4f} ms "
          "(the wrappers and launches)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
