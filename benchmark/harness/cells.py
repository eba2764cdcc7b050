"""The two kinds of cell a traffic mix can name: `train` (the S-step
training dispatch, driven as engine/loop drives it) and `render` (the
renderer, called as render_novel_pose calls it). Each runs set-up, the
measured window, an optional traced sub-window, and then, with the
program's state freed, the plain reference: the work counts the roofline
metrics read and the comparison that decides `correct`.

A run returns a namespace the metric readers (benchmark/metrics/) read:
`window` (the measured window's counts and seconds), `host` (the
benchmark's host-clock spans, ms), `trace` (harness/trace.py, traced runs
only), `flops` and `work` (a callable giving the reference's work counts
of the traced kernel launches), `numbers` (the numbers compared),
`compared` (the inputs, reference and program readings they came from,
for tools/readings.py) and device facts.
"""

from __future__ import annotations

import gc
import random
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import check, flops, inputs, program, trace as tracing
from benchmark.reference import body as rbody
from benchmark.reference import net as rnet
from benchmark.reference import raster as rr
from benchmark.reference import train as rtrain

INFERENCE_ITERATION = 10 ** 6


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _span(name):
    from torch.profiler import record_function

    return record_function(name)


def _ref_cfg(cfg: dict, x) -> dict:
    return {**cfg, "_body": x.body}


def _ref_batch(x, idx, cam: dict, device) -> dict:
    idx = np.asarray(idx).reshape(-1)
    B = idx.shape[0]
    b = {k: torch.as_tensor(np.stack([np.asarray(cam[k])] * B), device=device)
         for k in program.CAMERA_KEYS}
    b["pose"] = torch.as_tensor(x.pose[idx], device=device)
    b["transl"] = torch.as_tensor(x.transl[idx], device=device)
    return b


def _free():
    """Return the freed program state's device memory."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0


# ---------------------------------------------------------------- training

def _recording(base, n: int, S: int):
    """The program's optimizer class, recording at fixed places of every
    S-step dispatch: after its first step the first gradient as Adam holds
    it (m / (1 - b1)), after its n-th step the parameters. The records are
    device copies made inside the step, so the capture of the dispatch
    records them too and every replay refills them: after a replay they
    hold that replay's (two multi-tensor copies a dispatch)."""

    class Recording(base):
        def __init__(self, groups):
            super().__init__(groups)
            self.calls, self.grad1, self.after = 0, None, None

        @torch.no_grad()
        def step(self):
            super().step()
            at, self.calls = self.calls % S, self.calls + 1
            names = [k for o in self.groups.values() for k in o.names]
            if at == 0:
                mus = [m for o in self.groups.values() for m in o.mu]
                self.grad1 = dict(zip(names, torch._foreach_div(mus, 0.1)))
            if at == n - 1:
                ps = [p for o in self.groups.values() for p in o.params]
                self.after = dict(zip(names, torch._foreach_mul(ps, 1.0)))

    return Recording


def _groups(tr, cfg, mix):
    """The loop's dispatch groups from the start iteration on, epoch after
    epoch: -> (feeds, epoch, logged) each; `engine/loop.epoch_groups` decides
    which groups the loop logs (a loss read)."""
    from gaussianavatar_torch.engine.loop import DROP_KEYS, epoch_groups

    it = tr.state.iteration
    epoch = it // tr.per_epoch
    run_start = it
    while True:
        epoch += 1
        batches = iter(tr.loader)
        for g in epoch_groups(tr.per_epoch, tr.spd, it, run_start, tr.cfg.opt.log_iter):
            if not g.dispatch:
                raise ValueError("the mix's frames and batch leave a group shorter than S")
            feeds = [{k: v for k, v in next(batches).items() if k not in DROP_KEYS}
                     for _ in range(g.size)]
            it = g.end
            yield feeds, epoch, g.log


def _dispatch(tr, cfg, group):
    feeds, epoch, logged = group
    terms, _ = tr.steps(tr.state, feeds, program.w_rgl(cfg, epoch), 0.0, 0.0)
    return terms, logged


def run_train(cfg, mix, seed, seconds, traced, device, t_start) -> SimpleNamespace:
    k = int(mix["check_steps"])
    x = inputs.make(cfg, mix, seed, device)
    rec_cls = _recording(program.optimizer_base(), k, int(cfg["opt"]["steps_per_dispatch"]))
    tr = program.trainer(cfg, mix, x, seed, device, optimizer_cls=rec_cls)
    start = program.snapshot(tr)
    groups = _groups(tr, cfg, mix)

    # set-up: the first dispatch (eager, then captured), the rest of the
    # set-up epochs, and the retune the loop makes after epoch 1
    n_setup = int(mix["setup_epochs"]) * tr.per_epoch // tr.spd
    for _ in range(n_setup):
        g = next(groups)
        _dispatch(tr, cfg, g)
    tr.retune(g[1])
    # then the state drawn from the seed, put back into the same tensors
    # (the need table re-probed from it, its caps refilled in place), goes
    # through a replay of the captured dispatch on the loader's next
    # batches: the steps the reference follows, and the window's start
    program.restore(tr, start)
    groups = _groups(tr, cfg, mix)
    g = next(groups)
    terms, _ = _dispatch(tr, cfg, g)
    _sync(device)
    opt = tr.state.optimizer
    prog_loss = [float(v) for v in terms["total"][:k]]
    first_idx = [np.asarray(f["pose_idx"]) for f in g[0][:k]]
    prog_grad1 = {n: v.clone() for n, v in opt.grad1.items()}
    prog_delta = {n: opt.after[n] - x.weights[n] for n in opt.after if n in x.weights}
    prog_caps = tr.need.caps.clone()   # for the look of tools/readings.py only
    launches0 = program.launches()
    setup_s = time.time() - t_start

    host = {"feeds": [], "call": [], "log": []}
    steps = 0
    t0 = time.perf_counter()
    while True:
        h0 = time.perf_counter()
        g = next(groups)
        h1 = time.perf_counter()
        terms, logged = _dispatch(tr, cfg, g)
        h2 = time.perf_counter()
        if logged:
            {n: float(v[-1]) for n, v in terms.items()}
        h3 = time.perf_counter()
        for key, a, b in (("feeds", h0, h1), ("call", h1, h2), ("log", h2, h3)):
            host[key].append((b - a) * 1e3)
        steps += tr.spd
        if h3 - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    launches = {n: v - launches0.get(n, 0) for n, v in program.launches().items() if v}

    tr_ns, last_feeds = None, None
    if traced:
        n_tr = int(mix["trace_dispatches"])

        def work():
            nonlocal last_feeds
            for _ in range(n_tr):
                with _span("bench::feeds"):
                    g = next(groups)
                with _span("bench::dispatch"):
                    terms, logged = _dispatch(tr, cfg, g)
                if logged:
                    with _span("bench::log"):
                        {n: float(v[-1]) for n, v in terms.items()}
                last_feeds = g[0]

        tr_ns = tracing.record(work)
        tr_ns.steps = n_tr * tr.spd
    peak = _peak(device)
    num_valid = tr.assets.num_valid

    snap = None
    if traced:
        snap = ({n: p.detach().clone() for n, p in tr.net.named_parameters()},
                tr.need.caps.clone())
    del tr, groups, terms, g, opt
    if traced:
        del work
    _free()

    t_check = time.perf_counter()
    c = _ref_cfg(cfg, x)
    av = rbody.avatar(x.body, cfg["query_posmap_size"], 256, device)
    ref = _train_reference(c, mix, x, av, first_idx, device)
    numbers = check.train_numbers(prog_loss, prog_grad1, prog_delta, ref)
    numbers["_check_s"] = time.perf_counter() - t_check
    work_fn = None
    if traced:
        work_fn = lambda: _train_work(c, x, av, snap, last_feeds, device)
    return SimpleNamespace(
        kind="train", cfg=cfg, mix=mix, setup_s=setup_s, peak=peak, launches=launches,
        window={"steps": steps, "seconds": window_s, "dispatches": len(host["call"])},
        host=host, trace=tr_ns, numbers=numbers,
        flops={"step": flops.train_step_flops(cfg, num_valid)}, work=work_fn,
        attempted=steps, failed=0,
        compared=SimpleNamespace(x=x, av=av, c=c, idx=first_idx, ref=ref, loss=prog_loss,
                                 grad1=prog_grad1, delta=prog_delta, caps=prog_caps))


def _probe_caps(c, x, av, P, idx_pairs, device, q=None):
    """The need table's caps of the frames in `idx_pairs` (each a batch),
    as the set-up probe makes them: the network in eval mode at the
    inference iteration, every tile walked up to 4096 rows."""
    out = []
    with torch.no_grad():
        for idx in idx_pairs:
            b = _ref_batch(x, idx, x.cam, device)
            pm = x.posmaps[torch.as_tensor(idx, device=device).long()] \
                if c["train_stage"] == 2 else None
            world, shs, s3, op, _, _ = rtrain.gaussians(P, av, c, b, INFERENCE_ITERATION, False, pm,
                                                        q)
            T = (-(-x.size // c["tile_size"])) ** 2
            full = torch.full((len(idx) * T,), 4096, device=device)
            _, st = rtrain.draw(world, shs, s3, op, b, c, x.size, x.size,
                                c["max_tiles_per_gaussian"], full)
            out.append(rr.need_caps(st["n_contrib"], c["ragged_margin"]))
    return out


def _train_reference(c, mix, x, av, first_idx, device, q=None, caps=None, fault=None):
    """The reference's first steps on the compared batches from the
    benchmark's weights: its own need caps (from its probe, `q` rounding
    its decoder where given) unless `caps` is given -> train_steps' dict."""
    P0 = x.weights
    if caps is None:
        caps = _probe_caps(c, x, av, P0, first_idx, device, q)
    batches = [_ref_batch(x, idx, x.cam, device) for idx in first_idx]
    gts = [x.gt[torch.as_tensor(idx, device=device).long()].float() / 255.0 for idx in first_idx]
    pms = None
    if c["train_stage"] == 2:
        pms = [x.posmaps[torch.as_tensor(idx, device=device).long()] for idx in first_idx]
    start = int(mix["start_iteration"])
    epoch = start // (x.n // c["batch_size"]) + 1
    return rtrain.train_steps(P0, av, c, batches, gts, caps, start, program.w_rgl(c, epoch), pms,
                              q=q, fault=fault)


def _train_work(c, x, av, snap, feeds, device):
    """The reference's counts for the last traced dispatch's batches at the
    program's weights and need caps after the traced window: per batch (one
    H-bwd launch each), the contributing (gaussian, pixel) pairs, the
    gaussians binned and the pixels."""
    P, caps_all = snap
    out = []
    T = (-(-x.size // c["tile_size"])) ** 2
    with torch.no_grad():
        decoded = None
        if c["train_stage"] == 1:
            res, sc, shs, _ = rnet.decode(P, av, c, True)
            decoded = (res, sc, shs)
        for f in feeds:
            idx = np.asarray(f["pose_idx"]).reshape(-1)
            b = _ref_batch(x, idx, x.cam, device)
            ti = torch.as_tensor(idx, device=device).long()
            pm = x.posmaps[ti] if c["train_stage"] == 2 else None
            world, shs_, s3, op, _, _ = rtrain.gaussians(P, av, c, b, INFERENCE_ITERATION, True, pm,
                                                         decoded=decoded)
            _, st = rtrain.draw(world, shs_, s3, op, b, c, x.size, x.size,
                                c["max_tiles_per_gaussian"], caps_all[ti].reshape(-1))
            out.append({"contributing": st["contributing"], "gaussians": st["gaussians"],
                        "pixels": st["pixels"]})
    return out


# ---------------------------------------------------------------- rendering

def _render_batches(mix, x, seed):
    """Calls of `batch` consecutive poses of the sequence, from a start the
    seed draws, round and round -> (pose indices, the numpy batch)."""
    B, n = int(mix["batch"]), x.n
    at = int(np.random.default_rng(seed).integers(n))
    cam = {k: np.asarray(v) for k, v in x.cam.items()}
    pm = None if getattr(x, "posmaps", None) is None else x.posmaps.cpu().numpy()
    while True:
        idx = (at + np.arange(B)) % n
        at = (at + B) % n
        batch = {"pose_idx": idx.astype(np.int32), "pose_data": x.pose[idx],
                 "transl_data": x.transl[idx],
                 **{k: np.stack([cam[k]] * B) for k in program.CAMERA_KEYS}}
        if pm is not None:
            batch["inp_pos_map"] = pm[idx]
        yield idx, batch


def run_render(cfg, mix, seed, seconds, traced, device, t_start) -> SimpleNamespace:
    x = inputs.make(cfg, mix, seed, device)
    rd = program.renderer(cfg, x, device)
    it = int(mix["scale_iteration"])
    calls = _render_batches(mix, x, seed)
    for _ in range(int(mix["warmup_calls"])):
        rd.render(next(calls)[1], iteration=it).cpu()
    _sync(device)
    launches0 = program.launches()
    setup_s = time.time() - t_start

    rng = random.Random(seed)
    keep, n_keep = [], int(mix["check_calls"])
    lat, host, frames = [], [], 0
    t0 = time.perf_counter()
    while True:
        idx, batch = next(calls)
        c0 = time.perf_counter()
        out = rd.render(batch, iteration=it)
        c1 = time.perf_counter()
        img = out.cpu()
        c2 = time.perf_counter()
        host.append((c1 - c0) * 1e3)
        lat.append((c2 - c0) * 1e3)
        frames += img.shape[0]
        # a uniform sample of the window's calls (reservoir), drawn from the seed
        n = len(lat)
        if len(keep) < n_keep:
            keep.append((idx, img))
        elif rng.random() < n_keep / n:
            keep[rng.randrange(n_keep)] = (idx, img)
        if c2 - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    launches = {n: v - launches0.get(n, 0) for n, v in program.launches().items() if v}

    tr_ns, traced_idx = None, []
    if traced:
        def work():
            for _ in range(int(mix["trace_calls"])):
                with _span("bench::batch"):
                    idx, batch = next(calls)
                with _span("bench::render"):
                    out = rd.render(batch, iteration=it)
                with _span("bench::to_host"):
                    out.cpu()
                traced_idx.append(idx)

        tr_ns = tracing.record(work)
        tr_ns.calls = len(traced_idx)
    peak = _peak(device)
    num_valid = rd.assets.num_valid
    del rd, out, calls
    if traced:
        del work
    _free()

    t_check = time.perf_counter()
    c = _ref_cfg(cfg, x)
    av = rbody.avatar(x.body, cfg["query_posmap_size"], 256, device)
    ref = _Reference(c, mix, x, av, device)
    rounded = _Reference(c, mix, x, av, device, q=rnet.bf16)
    maes, scale = [], []
    for idx, img in keep:
        r = ref.frames(idx)[0].cpu()
        maes += check.frame_maes(img, r)
        scale += check.frame_maes(rounded.frames(idx)[0].cpu(), r)
    del rounded
    compared = SimpleNamespace(x=x, av=av, c=c, idx=[i for i, _ in keep], ref=ref, scale=scale)
    check_s = time.perf_counter() - t_check
    work_fn = (lambda: [ref.frames(i)[1] for i in traced_idx]) if traced else None
    B = int(mix["batch"])
    return SimpleNamespace(
        kind="render", cfg=cfg, mix=mix, setup_s=setup_s, peak=peak, launches=launches,
        window={"calls": len(lat), "frames": frames, "seconds": window_s},
        host={"call": host, "latency": lat}, trace=tr_ns,
        numbers={**check.frame_numbers(maes, scale), "_check_s": check_s},
        flops={"call": flops.render_call_flops(cfg, num_valid, B)}, work=work_fn,
        attempted=len(lat), failed=0, compared=compared)


class _Reference:
    """The reference's frames of a call's poses, from the benchmark's
    weights in eval mode (stage 1 from one decode), `q` rounding its decoder
    where given -> (frames (B, 3, H, W), work counts)."""

    def __init__(self, c, mix, x, av, device, q=None):
        self.c, self.mix, self.x, self.av, self.device, self.q = c, mix, x, av, device, q
        self.decoded = None
        if c["train_stage"] == 1:
            with torch.no_grad():
                res, sc, shs, _ = rnet.decode(x.weights, av, c, False, q=q)
            self.decoded = (res, sc, shs)

    @torch.no_grad()
    def frames(self, idx):
        c, x, dev = self.c, self.x, self.device
        b = _ref_batch(x, idx, x.cam, dev)
        pm = None
        if c["train_stage"] == 2:
            pm = x.posmaps[torch.as_tensor(np.asarray(idx), device=dev).long()]
        world, shs, s3, op, _, _ = rtrain.gaussians(x.weights, self.av, c, b,
                                                    int(self.mix["scale_iteration"]), False, pm,
                                                    self.q, self.decoded)
        img, st = rtrain.draw(world, shs, s3, op, b, c, x.size, x.size,
                              c["render_max_tiles_per_gaussian"])
        return img, {"contributing": st["contributing"], "gaussians": st["gaussians"],
                     "pixels": st["pixels"]}


KINDS = {"train": run_train, "render": run_render}
