"""Small sizes of the benchmark's cells, for the CPU tests: the same
configurations and mixes with narrow layers and few, small frames."""

import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(rel):
    with open(os.path.join(BENCH, rel)) as f:
        return json.load(f)


def tiny(cell: str, bf16: bool = True):
    """-> (cfg, mix) of `cell` at a size the CPU runs in seconds."""
    stage, kind = int(cell[1]), cell.split("-")[1]
    cfg = load(f"configs/ga-smpl-s{stage}.json")
    cfg.update(query_posmap_size=64, inp_posmap_size=32, c_geom=8, c_pose=8, hsize=16, nf=4,
               tile_size=16, bf16_decoder=int(bf16))
    cfg["opt"] = dict(cfg["opt"], steps_per_dispatch=4)
    mix = load(f"traffic/{kind}.json")
    if kind == "train":
        mix.update(frames=8, image_size=64, trace_dispatches=1)
    else:
        mix.update(frames=16, image_size=64, check_calls=2, trace_calls=2, warmup_calls=1)
    return cfg, mix


def run(cell, limits, seed=12345678901, bf16=True, traced=False):
    from benchmark.run import run_cell

    cfg, mix = tiny(cell, bf16)
    return run_cell(cell, seed, 0.5, traced, device="cpu", overrides=(cfg, mix, limits))
