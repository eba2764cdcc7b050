"""Where the time of the port's stage-1 novel-pose render goes, on one card.

Builds the avatar and batches of chip_smoke.py (`make_slice`: query posmap
512, bf16 decoder, 4 frames of 1024^2 per call) and runs its renderer, the
`make_renderer` path itself, under torch.profiler. The stages are the
`render::*` ranges that engine/inference.py, ops/rasterize.py and
ops/rasterize_tile.py open around pose_gaussians, the attributes, the
projection, the binning, the blend and the untile. Per call it prints, for
each stage, the host time inside the range and the device time of the
kernels launched in it; then the wall time of a call, the device-busy share
(kernel time over wall) and the kernels by device time. `--fused_decoder`
renders through the fused decoder (its H-dfwd stages; the decode has no
range of its own, so its kernels show by name).

    python3 scripts/torch_render_profile.py [--calls 8] [--fused_decoder]
"""

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def range_times(events, prefixes, since=None):
    """Per `record_function` range whose name starts with one of `prefixes`:
    host ms (time inside the range on the host) and device ms (the kernels
    that start inside the range's device-side span; without such spans, the
    kernels the profiler linked to the range). Also device ms by kernel name
    and a note of how device time was attributed. Only events that start at
    or after `since` (profiler microseconds) count. A kernel launched
    through ctypes (H-fwd, H-bwd) is linked to no torch op, hence the spans."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host, linked = defaultdict(float), defaultdict(float)
    spans = defaultdict(list)
    kernels, kernel_times = defaultdict(float), []
    for e in events:
        if since is not None and e.time_range.start < since:
            continue
        if e.name.startswith(prefixes):
            if e.device_type == cpu:
                host[e.name] += e.cpu_time_total / 1e3
                linked[e.name] += e.device_time_total / 1e3
            elif e.device_type == cuda:
                spans[e.name].append((e.time_range.start, e.time_range.end))
        elif e.device_type == cuda:
            kernels[e.name] += e.self_device_time_total / 1e3
            kernel_times.append((e.time_range.start, e.self_device_time_total / 1e3))
    dev = {}
    for name in host:
        dev[name] = sum(ms for t, ms in kernel_times
                        if any(a <= t < b for a, b in spans[name])) if spans[name] \
            else linked[name]
    how = "kernels inside each range's device span" if any(spans.values()) \
        else "kernels linked to each range"
    return host, dev, kernels, how


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
    host, dev, kernels, how = range_times(prof.events(), ("render::",))
    busy_ms = sum(kernels.values())
    print(f"stage-1 render ({'fused' if args.fused_decoder else 'reference'} decoder), "
          f"{s.B} frames of {s.H}x{s.W} per call, {n} calls under "
          f"torch.profiler, per call, on {card}:")
    print(f"  {'range':26s} {'host ms':>9s} {'device ms':>10s}  (device: {how})")
    for name in sorted(host, key=lambda k: -dev[k]):
        print(f"  {name:26s} {host[name] / n:9.3f} {dev[name] / n:10.3f}")
    print(f"  {'sum of ranges':26s} {sum(host.values()) / n:9.3f} {sum(dev.values()) / n:10.3f}")
    print(f"  call: {wall_ms / n:.3f} ms wall under the profiler, {plain_call_ms:.3f} ms "
          f"without it ({s.B * 1000 / plain_call_ms:.1f} frames/s); device busy "
          f"{busy_ms / n:.3f} ms per call, {100 * busy_ms / wall_ms:.1f}% of the profiled wall")
    print("kernels by device time, per call:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms / n:8.3f} ms  {100 * ms / busy_ms:5.1f}%  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
