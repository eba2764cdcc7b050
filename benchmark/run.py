"""Run one cell of the benchmark of gaussianavatar_torch once, on one
NVIDIA GPU:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration
(benchmark/configs/<name>.json) and a traffic mix
(benchmark/traffic/<mix>.json, whose `kind` picks the driver in
benchmark/harness/cells.py). Metrics are read by benchmark/metrics/<name>.py,
each the cell's end-to-end metrics with --trace 0 and its per-layer ones
with --trace 1. The last line of standard output is one JSON object:
correct, attempted, failed, metrics, device (and with --trace 1 the
breakdown), then `check`, the numbers compared with their limits
(benchmark/limits/<cell>.json), which the last lines of standard error
repeat. With no CUDA device, or fewer than the cell asks for, the run fails
and prints no result; so does a run in whose process the JAX package, jax,
jaxlib or flax has been loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
# the program's and torch's build caches stay inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ.setdefault("OMP_NUM_THREADS", "4")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "gaussianavatar_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str):
    """-> (benchmark, workload entry, configuration, traffic mix, limits)."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    mix = load_json(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH, "limits", name + ".json"))
    return bench, w, cfg, mix, limits


def metrics_for(bench: dict, cell: str, traced: bool) -> list:
    """The cell's metric entries: end-to-end ones, or per-layer ones."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def read_metric(name: str, run):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             overrides=None):
    """One run of `cell` -> (result dict, the run namespace). `overrides`
    (cfg, mix, limits) replace the files' (tests at small sizes)."""
    from benchmark.harness import check
    from benchmark.harness.cells import KINDS
    from benchmark.harness.trace import op_times

    if overrides:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cfg, mix, limits = overrides
    else:
        bench, _, cfg, mix, limits = cell_spec(cell)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run = KINDS[mix["kind"]](cfg, mix, seed, seconds, traced, device, T_START)
    ok, shown = check.verdict(run.numbers, limits)
    metrics = {}
    for m in metrics_for(bench, cell, traced):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": run.peak}
    result = {"correct": bool(ok), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in op_times(run.trace)[:10]],
                               "idle_gaps": [[n, s] for n, s in run.trace.gaps[:10]]}
    result["check"] = shown
    return result, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    import torch

    _, w, *_ = cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"benchmark: {args.workload} needs {w['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import gaussianavatar_torch  # noqa: F401  (the program must be there)

    result, run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: the run's process loaded {bad}; no result", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"kernel launches in the window: {run.launches}", file=sys.stderr)
    med = {k: round(float(np.median(v)), 3) for k, v in run.host.items() if v}
    print(f"host spans in the window, median ms: {med}; window {run.window}", file=sys.stderr)
    print("numbers beside the check: " + json.dumps({k: v for k, v in run.numbers.items()
                                                       if k not in result["check"]}),
          file=sys.stderr)
    for name, v in result["check"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
