"""The comparisons that decide `correct`, each a number held against its
limit (benchmark/limits/<cell>.json).

Training (the first steps of a replay of the captured S-step dispatch,
made at the end of set-up from the seed's weights and zero moments put
back into the program's own tensors, with the need table re-probed from
them; against the plain reference's steps from the same weights, batches
and ground truth under its own probe's caps; the window goes on from that
replay's state):
  loss1_gap       |loss - reference loss| / |reference loss| of step 1;
  loss_gap        the same, the largest over the compared steps;
  grad_gap        per leaf |‖g‖ - ‖g_ref‖| / max(‖g_ref‖, the median
                  leaf's ‖g_ref‖) of the first step's gradient, the worst
                  leaf; grad_med_gap the median leaf's;
  change_gap      the same of each leaf's change after the compared steps,
                  the worst leaf; change_med_gap the median leaf's.
Leaves whose reference gradient is under a thousandth of the median
leaf's (biases that BatchNorm cancels) are left out of all four. The
limits file of a cell names the numbers it holds.

Rendering (a sample of the window's calls, drawn from the seed, against
the reference's frames of the same poses and weights):
  frame_rel       per frame, the mean |pixel - reference pixel| over its
                  pixels and channels, over the same of the reference's own
                  frame with its decoder rounded to bfloat16 (the
                  configurations' precision; reference/net.bf16): how many
                  times what rounding to the stated precision moves the
                  frame the program departs by; the mean over the compared
                  frames. The seed's weights set how far rounding moves a
                  frame (1e-4 to 1.6e-3, whole frames alike) and the ratio
                  takes that out; the mean keeps one frame that reads 2.6
                  from setting the limit, and one frame altered far fails it;
  frame_rel_max   the worst frame's ratio, and frame_mae its mean |pixel -
                  reference pixel|, shown beside them.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> dict:
    """-> {leaf: gap of the norms}, as the module doc says."""
    ref_n = {k: float(ref[k].norm()) for k in keep}
    med = statistics.median(ref_n.values())
    return {k: abs(float(prog[k].float().norm()) - ref_n[k]) / max(ref_n[k], med) for k in keep}


def kept_leaves(grad_ref: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(v.norm()) for k, v in grad_ref.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def train_numbers(prog_loss, prog_grad1, prog_delta, ref) -> dict:
    keep = kept_leaves(ref["grad1"])
    losses = [abs(p - r) / abs(r) for p, r in zip(prog_loss, ref["loss"])]
    out = {"loss1_gap": losses[0], "loss_gap": max(losses), "_losses": losses,
           "_leaves": len(keep), "_left_out": sorted(set(ref["grad1"]) - set(keep))}
    for name, prog, r in (("grad", prog_grad1, ref["grad1"]), ("change", prog_delta, ref["delta"])):
        gaps = leaf_gaps(prog, r, keep)
        worst = max(gaps, key=gaps.get)
        out.update({f"{name}_gap": gaps[worst], f"{name}_med_gap": statistics.median(gaps.values()),
                    f"_{name}_leaf": worst})
    return out


def frame_maes(frames: torch.Tensor, ref: torch.Tensor) -> List[float]:
    """Each frame's mean absolute difference; frames (B, 3, H, W)."""
    return (frames.float() - ref.float()).abs().mean(dim=(1, 2, 3)).tolist()


def frame_numbers(maes: List[float], scale: List[float]) -> dict:
    """`maes` the frames' gaps, `scale` the bfloat16 reference's gaps of
    the same frames."""
    rel = [m / max(s, 1e-7) for m, s in zip(maes, scale)]
    return {"frame_rel": statistics.mean(rel), "frame_rel_max": max(rel), "frame_mae": max(maes),
            "_maes": maes, "_scale": scale}


def verdict(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {'value', 'limit'}}) over the limits' names; a
    number missing or not finite fails."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and abs(v) != float("inf") and v <= lim
        ok = ok and good
        out[name] = {"value": v if good or (v is not None and v == v
                                            and abs(v) != float("inf")) else None,
                     "limit": lim}
    return ok, out
