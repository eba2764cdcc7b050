"""The readings a correctness limit is set from, taken in the process of a
run, on the very batches, poses and weights that run compared: the
control (the reference in the program's place, its decoder's matmuls
rounded both ways to a precision below the configurations' bfloat16: int8,
symmetric per tensor, for training, float8 e4m3 for rendering, each read
beside the other; reference/net.py says why), the planted fault "half of
the batch left out", and, for the look at what moves the sound runs' numbers, the
reference rounded to the program's own bfloat16 and the reference given
the program's need caps.
Each is held against the float32 reference by the cell's numbers and
judged by check.verdict against the cell's committed limits, as a run is.
benchmark/tools/readings.py prints them.
"""

from __future__ import annotations

import torch

from benchmark.harness import check
from benchmark.harness.cells import _Reference, _train_reference
from benchmark.reference import net as rnet

LOW = {"int8": rnet.int8, "fp8": rnet.fp8}
TRAIN = ("int8", "fp8", "half_batch", "bf16", "program_caps")
RENDER = ("fp8", "int8")


def _public(numbers: dict) -> dict:
    return {k: v for k, v in numbers.items() if not k.startswith("_")}


def train_readings(run, mix: dict, limits: dict, device, variants=TRAIN) -> dict:
    """{variant: {'numbers', 'correct', 'check'}} of a finished training
    run (`run.compared`). 'program_caps' is the program's own reading
    against the float32 reference stepped under the program's caps, and
    'bf16' under those caps too, against that same reference: with the
    caps' integers out of the way, what rounding alone moves."""
    k = run.compared
    out = {}
    ref_pc = None
    if {"bf16", "program_caps"} & set(variants):
        pc = [k.caps[torch.as_tensor(i, device=k.caps.device).long()].reshape(-1) for i in k.idx]
        ref_pc = _train_reference(k.c, mix, k.x, k.av, k.idx, device, caps=pc)
    for v in variants:
        if v in LOW:
            n = check.train_numbers(*_steps(_train_reference(k.c, mix, k.x, k.av, k.idx, device,
                                                             q=LOW[v])), k.ref)
        elif v == "half_batch":
            n = check.train_numbers(*_steps(_train_reference(k.c, mix, k.x, k.av, k.idx, device,
                                                             fault="half_batch")), k.ref)
        elif v == "bf16":
            n = check.train_numbers(*_steps(_train_reference(k.c, mix, k.x, k.av, k.idx, device,
                                                             q=rnet.bf16, caps=pc)), ref_pc)
        elif v == "program_caps":
            n = check.train_numbers(k.loss, k.grad1, k.delta, ref_pc)
        else:
            raise ValueError(f"unknown variant {v!r}")
        ok, shown = check.verdict(n, limits)
        out[v] = {"numbers": _public(n), "correct": ok, "check": shown,
                  "leaves": {"grad": n["_grad_leaf"], "change": n["_change_leaf"]}}
    return out


def _steps(r: dict) -> tuple:
    return r["loss"], r["grad1"], r["delta"]


def render_readings(run, mix: dict, limits: dict, device, variants=RENDER) -> dict:
    """{variant: ...} of a finished render run: the lower precisions'
    frames of the calls the run compared, against the reference's."""
    k = run.compared
    out = {}
    for v in variants:
        low = _Reference(k.c, mix, k.x, k.av, device, q=LOW[v])
        maes = [m for i in k.idx
                for m in check.frame_maes(low.frames(i)[0].cpu(), k.ref.frames(i)[0].cpu())]
        n = check.frame_numbers(maes, k.scale)
        ok, shown = check.verdict(n, limits)
        out[v] = {"numbers": _public(n), "correct": ok, "check": shown, "maes": maes}
    return out
