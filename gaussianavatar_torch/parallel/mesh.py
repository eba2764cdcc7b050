"""Frame data parallelism on torch.distributed (counterpart of
gaussianavatar_tpu/parallel/mesh.py, whose mesh axis name `DATA_AXIS` it
keeps).

A data-parallel group is `dp` processes, one rank each, that train one
avatar on shards of every global batch:

  - rank r runs on `cuda:(r % device_count)`, or on the CPU;
  - the backend is NCCL when every rank has a card of its own, and gloo
    when ranks share a card or run on the CPU (NCCL refuses two ranks on
    one GPU; gloo reduces and broadcasts CUDA tensors through the host).
    `backend_for` is the whole rule: a failed NCCL start fails the run, it
    never falls back to gloo;
  - the ranks meet through a `file://` store in the run's temporary
    directory (no fixed TCP port, so concurrent runs on one machine do not
    collide);
  - every rank draws the same shuffle (the same `BatchLoader` seed), and
    `shard_batch` gives rank r frames [r B/dp, (r+1) B/dp) of each global
    batch, so a `dp` run sees the frames a `dp = 1` run sees, in the same
    order;
  - `replicate` broadcasts rank 0's network after init or resume;
  - `all_reduce_grads` sums every parameter's gradient over the ranks in
    one flat buffer and divides by dp: the gradient of the global batch's
    mean loss, as the JAX package's psum gives it;
  - BatchNorm layers in training mode (models/layers.FlaxBatchNorm) take
    their statistics over the global batch through `global_sum`, an
    all-reduce whose backward sums the statistics' gradient over the ranks.

`spawn_ranks` starts the group's processes (torch.multiprocessing), one
command as in the JAX CLI; the process-wide group is `group()`, None
outside a group.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from datetime import timedelta
from typing import Callable, Dict, Iterable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "dp"

# the rendezvous's and every collective's limit when the caller gives none
DEFAULT_TIMEOUT_S = 1800.0


class DataGroup(NamedTuple):
    rank: int
    dp: int
    backend: str   # "nccl" | "gloo"
    device: str    # this rank's device, "cuda:i" or "cpu"


_GROUP: Optional[DataGroup] = None


def group() -> Optional[DataGroup]:
    """This process's data-parallel group, or None."""
    return _GROUP


def backend_for(device: str, dp: int, device_count: int) -> str:
    """NCCL when every one of the dp ranks has a card of its own, else gloo
    (ranks that share a card, or run on the CPU)."""
    if torch.device(device).type == "cuda" and device_count >= dp:
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int, device_count: int) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    return f"cuda:{rank % device_count}"


def check_batch(batch_size: int, dp: int):
    """The JAX CLI's check: each rank takes an equal share of the batch."""
    if batch_size % dp:
        raise ValueError(f"--batch_size ({batch_size}) must be a multiple of --dp ({dp})")


def init_group(rank: int, dp: int, device: str, init_file: str,
               timeout_s: Optional[float] = None) -> DataGroup:
    """Join the group of `dp` ranks that meet at `init_file` as rank `rank`
    and make it this process's group."""
    global _GROUP
    count = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    backend = backend_for(device, dp, count)
    dev = rank_device(device, rank, count)
    if dev != "cpu":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=dp,
                            rank=rank, timeout=timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S))
    _GROUP = DataGroup(rank, dp, backend, dev)
    where = "one card each" if backend == "nccl" else \
        "on the CPU" if dev == "cpu" else f"sharing {count} card(s)"
    print(f"data-parallel: {dp} ranks over {backend} ({where})")
    return _GROUP


def close_group():
    global _GROUP
    if _GROUP is not None:
        dist.destroy_process_group()
        _GROUP = None


def _rank_entry(rank, fn, dp, device, init_file, timeout_s, threads, args):
    torch.set_num_threads(threads)
    if rank:
        # one rank speaks: the others' lines would repeat rank 0's
        sys.stdout = open(os.devnull, "w")
    init_group(rank, dp, device, init_file, timeout_s)
    try:
        fn(*args)
    finally:
        close_group()


def spawn_ranks(fn: Callable, dp: int, device: str, args: tuple = (),
                timeout_s: Optional[float] = None):
    """fn(*args) in each of `dp` new processes, each a rank of one group on
    `device` (rank 0 alone prints). Returns when every rank has returned;
    raises if a rank fails (the others are stopped) or, with `timeout_s`,
    if the ranks have not all returned in that time (they are killed).
    Each rank takes 1/dp of this process's CPU threads."""
    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // dp)
    with tempfile.TemporaryDirectory(prefix="gsavatar_dp_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        ctx = mp.spawn(_rank_entry, args=(fn, dp, device, init_file, timeout_s, threads, args),
                       nprocs=dp, join=False)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the {dp} ranks did not finish within {timeout_s:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()


def shard_batch(batch: dict, grp: Optional[DataGroup]) -> dict:
    """Rank r's frames [r B/dp, (r+1) B/dp) of a global batch (every leaf
    split along its leading axis); the batch itself without a group."""
    if grp is None:
        return batch
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // grp.dp
        out[k] = v[grp.rank * per:(grp.rank + 1) * per]
    return out


@torch.no_grad()
def replicate(module: nn.Module, grp: Optional[DataGroup]):
    """Every parameter and buffer of `module` from rank 0."""
    if grp is None:
        return
    for t in (*module.parameters(), *module.buffers()):
        dist.broadcast(t.data, 0)


@torch.no_grad()
def all_reduce_grads(params: Iterable[nn.Parameter], grp: DataGroup):
    """Each trainable parameter's gradient -> its mean over the ranks, by
    one all-reduce of one flat buffer (a missing gradient counts as 0)."""
    params = [p for p in params if p.requires_grad]
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat)
    flat.div_(grp.dp)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


# terms that count things over the batch: summed over the ranks, not averaged
SUMMED_TERMS = ("raster_overflow",)


@torch.no_grad()
def all_reduce_terms(terms: Dict[str, torch.Tensor], grp: DataGroup) -> Dict[str, torch.Tensor]:
    """The ranks' scalar loss terms -> the global batch's: means over the
    ranks (each rank's term is the mean over its equal share), counts summed."""
    keys = list(terms)
    flat = torch.stack([terms[k].float().reshape(()) for k in keys])
    dist.all_reduce(flat)
    return {k: flat[i] if k in SUMMED_TERMS else flat[i] / grp.dp for i, k in enumerate(keys)}


def sum_counts(counts: Dict[str, int], grp: Optional[DataGroup]) -> Dict[str, int]:
    """Integer counts (e.g. kernel launches) summed over the ranks."""
    if grp is None:
        return dict(counts)
    keys = sorted(counts)
    # integers stay on the host under gloo; NCCL reduces on the card only
    t = torch.tensor([int(counts[k]) for k in keys], dtype=torch.int64,
                     device=grp.device if grp.backend == "nccl" else "cpu")
    dist.all_reduce(t)
    return {k: int(v) for k, v in zip(keys, t.tolist())}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradient over the
    ranks too (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def syncs_batch_stats() -> bool:
    """Whether BatchNorm takes global statistics here: inside a group."""
    return _GROUP is not None


def global_sum(local: torch.Tensor) -> torch.Tensor:
    """`local` summed over the group's ranks, differentiably. Every rank
    must call it the same number of times in the same order (BatchNorm
    layers do, in the order of the network)."""
    return _AllReduceSum.apply(local)

