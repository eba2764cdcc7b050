"""Where the time of the port's stage-1 novel-pose render goes, on one card.

Builds the avatar and batches of chip_smoke.py (`make_slice`: query posmap
512, bf16 decoder, 4 frames of 1024^2 per call) and runs its renderer, the
`make_renderer` path itself, under torch.profiler. The stages are the
program's spans (utils/spans.py), read on the device from their marker
kernels: `render::call` around each call, and inside it the `render::*`
spans that engine/inference.py, ops/rasterize.py and ops/rasterize_tile.py
open around pose_gaussians, the attributes, the projection, the binning,
the blend and the untile (the canonical decode, `render::decode`, runs once
at set-up). Per call it prints each span's device busy time (its kernels,
copies and fills) and the time inside it in which the device ran nothing;
then the wall time of a call, the device-busy share and the kernels by
device time. `--fused_decoder` renders through the fused decoder.

    python3 scripts/torch_render_profile.py [--calls 8] [--fused_decoder]
"""

import argparse
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--fused_decoder", action="store_true",
                    help="decode through ShapeDecoderFused")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_render_profile: needs CUDA", file=sys.stderr)
        return 2
    import chip_smoke
    from gaussianavatar_torch.utils.spans import device_spans, span_times, trace_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    s = chip_smoke.make_slice("cuda", "fused" if args.fused_decoder else "ref")
    n = args.calls
    batches = [s.batch_for(s.B * i) for i in range(n)]
    for b in batches:  # warm-up: kernel build, allocator, cuBLAS handles
        s.render(b, s.iteration)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        s.render(b, s.iteration)
    torch.cuda.synchronize()
    plain_call_ms = (time.perf_counter() - t0) * 1e3 / n

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches:
            s.render(b, s.iteration)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = trace_ops(prof)
    times = span_times(ops)
    kernels = {}
    for name, _, d in ops:
        kernels[name] = kernels.get(name, 0.0) + d / 1e3
    busy_ms = sum(kernels.values())
    calls = device_spans(ops)["render_call"]
    print(f"stage-1 render ({'fused' if args.fused_decoder else 'reference'} decoder), "
          f"{s.B} frames of {s.H}x{s.W} per call, {len(calls)} calls under "
          f"torch.profiler, per call, on {card}:")
    print(f"  {'span':26s} {'busy ms':>9s} {'idle ms':>9s}")
    for name, (_, busy, idle) in sorted(times.items(), key=lambda kv: -kv[1][1]):
        print(f"  {name:26s} {busy / 1e3 / n:9.3f} {idle / 1e3 / n:9.3f}")
    print(f"  call: {wall_ms / n:.3f} ms wall under the profiler, {plain_call_ms:.3f} ms "
          f"without it ({s.B * 1000 / plain_call_ms:.1f} frames/s); device busy "
          f"{busy_ms / n:.3f} ms per call, {100 * busy_ms / wall_ms:.1f}% of the profiled wall")
    print("kernels by device time, per call:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms / n:8.3f} ms  {100 * ms / busy_ms:5.1f}%  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
