"""The train step (counterpart of make_train_step in
gaussianavatar_tpu/engine/train_step.py), stage 1 and stage 2:

    GT from the uint8 bank on the device, indexed by pose_idx
    -> embedding lookup
    -> POP decode in training mode. Stage 1: ONCE (the decoder sees no
       per-frame input; BatchNorm on the statistics of that one copy, as the
       JAX dedup takes them), then expanded to the batch. Stage 2: the B
       frames' input posmaps (from the posmap bank on the device, indexed
       by pose_idx, or the one fixed posmap) through the UNet pose encoder,
       B decodes, the decoder's BatchNorm statistics over all B x Nv points
    -> LBS + skinning -> scale warm-up at the step's iteration (stage 1)
    -> rasterize (H-fwd; H-bwd on the way back)
    -> loss, stage 1 = scale + offset + L1 * (1 - lambda_dssim)
                       + lambda_dssim * (1 - SSIM) + geo;
       stage 2 = offset + L1 * (1 - lambda_dssim) + lambda_dssim * (1 - SSIM)
                 + lambda_pose * mean(pose_featmap^2);
       with LPIPS weights, + lpips_gate * lambda_lpips * LPIPS(images, GT)
       (both mapped to [-1, 1]; logged as `vgg` whatever the gate);
       with a neighbour graph (`aiap_nn`, --use_aiap), + lambda_aiap *
       aiap_loss(query points + offsets, world points) over the valid
       points (logged as `aiap`)
    -> backward -> inside a data-parallel group (parallel/mesh.py), every
       gradient all-reduced to its mean over the ranks
    -> embedding gradients times the pose-optimization gate
    -> the optimizer groups (engine/optim.py).

Inside a group each rank steps on its shard of the global batch; the
BatchNorm layers take the global batch's statistics (stage 1's one decode,
alike on every rank, too: its synced statistics equal its own); the
binning budgets its depth key for the global batch
(RasterizeConfig.key_views), so a rank's frames blend in the order the
whole batch's would; the logged terms are the
global batch's (parallel/mesh.all_reduce_terms). SparseAdam then finds the
touched embedding rows in the all-reduced gradient: the union over the
ranks, as in the JAX package's psum.

Where the JAX step returns a new state, this one updates `TrainState` in
place: the network's parameters and BatchNorm statistics, the optimizer's
moments and counts, and the iteration counter. The stages open `train::*`
and `render::*` profiler ranges (scripts/torch_train_profile.py reads them);
each costs one `record_function` per step.

`make_train_steps` is the counterpart of the JAX `make_train_step_scan`: S
steps on S stacked batches in one dispatch, the trajectory of S sequential
steps. Both it and `make_train_step` run one step body. Everything the body
reads that changes from step to step lives on the device, so a CUDA graph
that records S bodies replays them at any later step: the iteration (an
int32 device counter the body advances; `TrainState.iteration` is its
Python mirror, written into it before each dispatch), the scale warm-up (a
device select on that counter), Adam's counts, rates and bias corrections
(engine/optim.py), `w_rgl` and the two gates (float32 device scalars
written before each dispatch), the batch (copied into static buffers) and
the need table's caps (refilled in place at a retune).
The body reads nothing back to the host: the blend's backward takes the
whole slot table (ops/rasterize_tile.BlendTiles). On a card the first
dispatch for each (pose gate on, LPIPS gate on) pair runs its S steps
eagerly (kernel builds, library initialisation; part of the trajectory)
and then captures the graph, which every later dispatch of that pair
replays; a capture that fails raises, nothing falls back to eager. On the
CPU, and inside a data-parallel group (gloo collectives cannot be
captured), the S steps run one after another through the same body.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from gaussianavatar_torch.engine.inference import _to_device
from gaussianavatar_torch.engine.optim import GroupOptimizer
from gaussianavatar_torch.models.avatar import (
    AvatarAssets, AvatarNet, gaussian_attributes, pose_gaussians, scale_warmup,
)
from gaussianavatar_torch.models.body import BodyModel
from gaussianavatar_torch.ops.knn import aiap_loss
from gaussianavatar_torch.ops.rasterize import RasterizeConfig, rasterize_views
from gaussianavatar_torch.ops.ssim import l1_loss, ssim
from gaussianavatar_torch.parallel import mesh
from gaussianavatar_torch.utils.cuda_build import GraphLaunches


@dataclass
class TrainState:
    net: AvatarNet
    optimizer: GroupOptimizer
    iteration: int = 0   # optimizer steps taken


class StepScalars:
    """What the step body reads that the loop sets per dispatch, as device
    scalars: the iteration before the dispatch (int32; the body advances
    it), `w_rgl` and the two gates (float32)."""

    def __init__(self, device):
        self.iteration = torch.zeros((), dtype=torch.int32, device=device)
        f32 = lambda: torch.zeros((), dtype=torch.float32, device=device)
        self.w_rgl, self.pose_gate, self.lpips_gate = f32(), f32(), f32()

    def write(self, iteration: int, w_rgl: float, pose_opt_gate: float, lpips_gate: float):
        self.iteration.fill_(iteration)
        self.w_rgl.fill_(w_rgl)
        self.pose_gate.fill_(pose_opt_gate)
        self.lpips_gate.fill_(lpips_gate)


def _make_body(net, body_model, assets, opt_cfg, H, W, bg_color, raster_cfg, gt_bank,
               train_stage, lpips_fn, aiap_nn, inp_bank, need_caps):
    """-> body(state, b, sc, lpips_on) -> (terms, images): one optimizer step
    on the batch `b` (tensors on the device), reading the iteration and the
    gates from `sc` (StepScalars) and advancing its iteration; `lpips_on`
    (the LPIPS gate is not 0) decides whether the term joins the loss and
    its gradient. Nothing is read back to the host."""
    if train_stage not in (1, 2):
        raise ValueError(f"train_stage must be 1 or 2, got {train_stage}")
    if train_stage == 2 and inp_bank is None:
        raise ValueError("stage 2 needs the input posmap bank (inp_bank)")
    device = assets.query_points.device
    grp = mesh.group()
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=device)
    embeddings = (net.pose_embedding, net.transl_embedding)

    def body(state: TrainState, b: dict, sc: StepScalars, lpips_on: bool):
        with record_function("train::step"):
            return _body(state, b, sc, lpips_on)

    def _body(state, b, sc, lpips_on):
        sc.iteration += 1
        idx = b["pose_idx"].long().reshape(-1)
        B = idx.shape[0]
        gt = gt_bank[idx].float() / 255.0
        net.train()
        state.optimizer.zero_grad()

        with record_function("train::decode"):
            pose, transl = net.lookup(idx)
            if train_stage == 1:
                # the stage-1 decoder sees no per-frame input: decode once, expand
                res, scales, shs, _ = net.decode(assets, 1)
                res, scales, shs = (x.expand(B, -1, -1) for x in (res, scales, shs))
            else:
                inp = inp_bank[idx * 0 if inp_bank.shape[0] == 1 else idx]
                res, scales, shs, pose_featmap = net.decode(assets, B, inp)
        with record_function("render::pose_gaussians"):
            world = pose_gaussians(body_model, assets, pose, transl, res,
                                   rest_pose=b.get("rest_pose"))
        with record_function("render::attributes"):
            # the scale warm-up is stage 1's only
            scales3, rotations, opacity = gaussian_attributes(
                assets, scale_warmup(scales, sc.iteration) if train_stage == 1 else scales)
        images, overflow = rasterize_views(
            world, shs, scales3, rotations, opacity,
            b["world_view_transform"], b["full_proj_transform"],
            b["tan_fovx"].reshape(B), b["tan_fovy"].reshape(B), H, W, bg,
            config=raster_cfg if grp is None else raster_cfg._replace(key_views=B * grp.dp),
            caps=None if need_caps is None else need_caps[idx].reshape(-1))

        with record_function("train::loss"):
            l1 = (1.0 - opt_cfg.lambda_dssim) * l1_loss(images, gt)
            ssim_loss = opt_cfg.lambda_dssim * (1.0 - ssim(images, gt))
            offset_loss = sc.w_rgl * torch.mean(res ** 2)
            if train_stage == 1:
                geo_loss = torch.mean(net.geo_feature ** 2)
                scale_loss = opt_cfg.lambda_scale * torch.mean(scales3)
                loss = scale_loss + offset_loss + l1 + ssim_loss + geo_loss
                terms = dict(l1=l1, ssim=ssim_loss, scale=scale_loss, offset=offset_loss,
                             geo=geo_loss)
            else:
                pose_loss = torch.mean(pose_featmap ** 2) * opt_cfg.lambda_pose
                loss = offset_loss + l1 + ssim_loss + pose_loss
                terms = dict(l1=l1, ssim=ssim_loss, offset=offset_loss, pose=pose_loss)
            if aiap_nn is not None:
                with record_function("train::aiap"):
                    nv = assets.num_valid
                    cano = assets.query_points[None, :nv] + res[:, :nv]
                    aiap = opt_cfg.lambda_aiap * aiap_loss(cano, world[:, :nv], aiap_nn)
                loss = loss + aiap
                terms["aiap"] = aiap
        if lpips_fn is not None:
            with record_function("train::lpips"):
                # at gate 0 the term is only logged: it leaves no gradient
                with torch.set_grad_enabled(lpips_on):
                    vgg = opt_cfg.lambda_lpips * lpips_fn((images - 0.5) * 2, (gt - 0.5) * 2)
                if lpips_on:
                    loss = loss + sc.lpips_gate * vgg
                terms["vgg"] = vgg
        with record_function("train::backward"):
            loss.backward()
        if grp is not None:
            with record_function("train::all_reduce"):
                mesh.all_reduce_grads(net.parameters(), grp)

        with record_function("train::optimizer"):
            # the epoch gate of pose optimization: zero gradients touch no row
            for p in embeddings:
                if p.grad is not None:
                    p.grad.mul_(sc.pose_gate)
            state.optimizer.step()
        terms.update(total=loss, raster_overflow=overflow.to(torch.float32))
        terms = {k: v.detach() for k, v in terms.items()}
        if grp is not None:
            terms = mesh.all_reduce_terms(terms, grp)
        return terms, images.detach()

    return body


def make_train_step(
    net: AvatarNet,
    body_model: BodyModel,
    assets: AvatarAssets,
    opt_cfg,
    H: int,
    W: int,
    bg_color,
    raster_cfg: RasterizeConfig,
    gt_bank: torch.Tensor,           # (n_frames, 3, H, W) uint8 on the device
    train_stage: int = 1,
    lpips_fn: Optional[Callable] = None,   # ops/lpips.LPIPS on the device, or None
    aiap_nn: Optional[torch.Tensor] = None,   # (num_valid, k) neighbour indices, --use_aiap
    inp_bank: Optional[torch.Tensor] = None,  # (n_frames | 1, 3, F, F) f32, stage 2
    need_caps: Optional[torch.Tensor] = None,  # (n_frames, T) int32 per-tile row caps
):
    """-> train_step(state, batch, w_rgl, pose_opt_gate, lpips_gate) ->
    (terms, images): one optimizer step on `batch` (numpy arrays keyed as
    the dataset's items, without the image). `terms` holds the loss terms,
    `total` and `raster_overflow` as detached scalars; the gates are floats,
    0 or 1. Stage 2 needs `inp_bank`: every training frame's input posmap,
    or one row, the fixed posmap every frame takes. With `need_caps` (the
    need table, engine/need_table.py) each frame's tiles blend at most its
    row's caps, read at every step."""
    body = _make_body(net, body_model, assets, opt_cfg, H, W, bg_color, raster_cfg, gt_bank,
                      train_stage, lpips_fn, aiap_nn, inp_bank, need_caps)
    device = assets.query_points.device
    sc = StepScalars(device)

    def train_step(state: TrainState, batch: dict, w_rgl: float, pose_opt_gate: float,
                   lpips_gate: float = 0.0):
        sc.write(state.iteration, w_rgl, pose_opt_gate, lpips_gate)
        out = body(state, _to_device(batch, device), sc, lpips_gate != 0.0)
        state.iteration += 1
        return out

    return train_step


class GraphReplay:
    """`fn` (no arguments, device work only) captured once into a CUDA graph
    on the current device, then replayed: `replay()` -> what `fn` returned
    at capture, its tensors refilled. The launches the graph records are
    counted once per replay (utils/cuda_build.GraphLaunches). Dropout
    generators other than the default one are registered with the graph,
    so each replay draws fresh masks. A capture that fails raises; `warm`
    runs `fn` eagerly on a side stream, as the capture will."""

    def __init__(self, fn: Callable, generators: Sequence[torch.Generator] = ()):
        self.launches = GraphLaunches()
        t0 = time.perf_counter()
        try:
            with self.launches.capturing():
                self.out = self._capture(fn, generators)
        except RuntimeError as e:
            raise RuntimeError(
                "CUDA graph capture of the S-step dispatch failed (a host read or a call that "
                f"cannot be captured inside the step); training does not fall back to eager "
                f"steps: {e}") from e
        self.capture_s = time.perf_counter() - t0

    def _capture(self, fn, generators):
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph):
            return fn()

    def _replay(self):
        self.graph.replay()

    def replay(self):
        self._replay()
        self.launches.replayed()
        return self.out

    @staticmethod
    def warm(fn: Callable):
        """fn() on a side stream (lazy initialisation happens here, on a
        stream that is not the default one, as in the capture)."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(main.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()
        main.wait_stream(side)
        return out


def dropout_generators(net: torch.nn.Module, device) -> list:
    """The explicit generators the network's dropout layers draw from
    (None: the device's default generator, which a CUDA graph tracks
    itself). A CPU generator cannot feed a graph on the card: refused."""
    gens = []
    for m in net.modules():
        g = getattr(m, "generator", None)
        if getattr(m, "use_dropout", False) and g is not None and g not in gens:
            if g.device.type != torch.device(device).type:
                raise ValueError(f"dropout draws from a {g.device} generator: a CUDA graph on "
                                 f"{device} needs a generator on that device")
            gens.append(g)
    return gens


def make_train_steps(
    net: AvatarNet,
    body_model: BodyModel,
    assets: AvatarAssets,
    opt_cfg,
    H: int,
    W: int,
    bg_color,
    raster_cfg: RasterizeConfig,
    gt_bank: torch.Tensor,
    steps: int,
    train_stage: int = 1,
    lpips_fn: Optional[Callable] = None,
    aiap_nn: Optional[torch.Tensor] = None,
    inp_bank: Optional[torch.Tensor] = None,
    need_caps: Optional[torch.Tensor] = None,
    graph_cls: Optional[type] = None,
):
    """The S-step dispatch (S = `steps`), counterpart of the JAX
    `make_train_step_scan`: -> train_steps(state, feeds, w_rgl,
    pose_opt_gate, lpips_gate) -> (terms, images). `feeds` is S batches as
    `make_train_step` takes them, stacked here on a leading step axis into
    static device buffers; the S steps run on them in order with the
    epoch's `w_rgl` and gates. `terms` holds each term as an (S,) tensor,
    `images` the last step's renders: what the JAX scan returns. On a card
    outside a data-parallel group the dispatch is one replay of a CUDA
    graph of the S steps (GraphReplay, or `graph_cls` where given),
    captured after the first dispatch of each (pose gate on, LPIPS gate on)
    pair ran eagerly; elsewhere the S steps run one after another through
    the same body."""
    if steps < 2:
        raise ValueError(f"make_train_steps takes S >= 2 steps, got {steps}")
    body = _make_body(net, body_model, assets, opt_cfg, H, W, bg_color, raster_cfg, gt_bank,
                      train_stage, lpips_fn, aiap_nn, inp_bank, need_caps)
    device = assets.query_points.device
    sc = StepScalars(device)
    if graph_cls is None and device.type == "cuda" and mesh.group() is None:
        graph_cls = GraphReplay
    generators = dropout_generators(net, device) if graph_cls is not None else []
    bufs: Dict[str, torch.Tensor] = {}
    graphs: Dict[tuple, object] = {}

    def fill(feeds: Sequence[dict]):
        """The S feeds into the static buffers; a new layout reallocates
        them and drops the graphs that read the old ones."""
        for k in feeds[0]:
            v = torch.as_tensor(np.stack([np.asarray(f[k]) for f in feeds]))
            dtype = torch.float32 if v.is_floating_point() else v.dtype
            if k not in bufs or bufs[k].shape != v.shape or bufs[k].dtype != dtype:
                bufs[k] = torch.empty(v.shape, dtype=dtype, device=device)
                graphs.clear()
            bufs[k].copy_(v)

    def run(state, lpips_on):
        outs = [body(state, {k: v[i] for k, v in bufs.items()}, sc, lpips_on)
                for i in range(steps)]
        terms = {k: torch.stack([t[k] for t, _ in outs]) for k in outs[0][0]}
        return terms, outs[-1][1]

    def train_steps(state: TrainState, feeds: Sequence[dict], w_rgl: float,
                    pose_opt_gate: float, lpips_gate: float = 0.0):
        if len(feeds) != steps:
            raise ValueError(f"{len(feeds)} feeds for a dispatch of {steps} steps")
        with record_function("train::dispatch"):
            fill(feeds)
            sc.write(state.iteration, w_rgl, pose_opt_gate, lpips_gate)
            key = (pose_opt_gate != 0.0, lpips_gate != 0.0)
            if graph_cls is None:
                terms, images = run(state, key[1])
            elif key in graphs:
                terms, images = graphs[key].replay()
                # the graph's outputs are refilled by its next replay
                terms, images = {k: v.clone() for k, v in terms.items()}, images.clone()
            else:
                # this dispatch eagerly (part of the trajectory), then the
                # capture; a gate flips once a run: the other pair's graph
                # is done
                terms, images = graph_cls.warm(lambda: run(state, key[1]))
                # the eager gradients go before the capture, not inside it
                state.optimizer.zero_grad()
                graphs.clear()
                graphs[key] = graph_cls(lambda: run(state, key[1]), generators)
                print(f"captured a CUDA graph of {steps} training steps (pose gate "
                      f"{'on' if key[0] else 'off'}, LPIPS gate {'on' if key[1] else 'off'}) "
                      f"in {graphs[key].capture_s:.2f} s, launches per replay "
                      f"{graphs[key].launches.per_replay}")
            state.iteration += steps
        return terms, images

    return train_steps
