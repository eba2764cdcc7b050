"""The system under test, built from the benchmark's inputs through the
program's own entry points: its configuration, body model, avatar assets
(the program derives them from the body and the atlas), network (the
benchmark's weights loaded into it), optimizer, need table and S-step
training dispatch, or its renderer. Only this file and the metric readers'
kernel names know the program's module layout.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

# the camera arrays of a frame that the train step and the renderer read
CAMERA_KEYS = ("world_view_transform", "full_proj_transform", "tan_fovx", "tan_fovy")


def config(cfg: dict):
    from gaussianavatar_torch.config import (
        Config, ModelParams, NetworkParams, OptimizationParams, RasterParams,
    )
    o = cfg["opt"]
    return Config(
        ModelParams(train_stage=cfg["train_stage"], query_posmap_size=cfg["query_posmap_size"],
                    inp_posmap_size=cfg["inp_posmap_size"], batch_size=cfg["batch_size"],
                    white_background=cfg["white_background"], dataset_type="synthetic"),
        NetworkParams(c_pose=cfg["c_pose"], c_geom=cfg["c_geom"], hsize=cfg["hsize"],
                      nf=cfg["nf"], up_mode=cfg["up_mode"],
                      geom_layer_type=cfg["geom_layer_type"], bf16_decoder=cfg["bf16_decoder"],
                      fused_decoder=cfg["fused_decoder"]),
        OptimizationParams(lambda_dssim=o["lambda_dssim"], lambda_scale=o["lambda_scale"],
                           lambda_pose=o["lambda_pose"], lambda_rgl=o["lambda_rgl"],
                           lr_net=o["lr_net"], lr_geomfeat=o["lr_geomfeat"],
                           lr_pose=o["lr_pose"], steps_per_dispatch=o["steps_per_dispatch"],
                           epochs=o["epochs"]),
        RasterParams(tile_size=cfg["tile_size"],
                     max_tiles_per_gaussian=cfg["max_tiles_per_gaussian"],
                     render_max_tiles_per_gaussian=cfg["render_max_tiles_per_gaussian"],
                     ragged=cfg["ragged"], auto_cascade=cfg["auto_cascade"],
                     ragged_margin=cfg["ragged_margin"],
                     train_footprint_adapt=cfg["train_footprint_adapt"]))


def avatar(cfg: dict, x, device):
    """-> (program Config, body model, assets, network in eval mode)."""
    from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
    from gaussianavatar_torch.models.body import BodyModel

    c = config(cfg)
    b = x.body
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    model = BodyModel(v_template=t(b.v_template), shapedirs=t(b.shapedirs),
                      posedirs=t(b.posedirs), J_regressor=t(b.J_regressor),
                      lbs_weights=t(b.lbs_weights), parents=b.parents.astype(np.int32),
                      faces=b.faces, model_type="smpl")
    J = b.parents.shape[0]
    assets = build_avatar_assets(model, b.v_template, b.uvs, b.faces, b.faces_vt,
                                 np.zeros(J * 3, np.float32),
                                 np.zeros(b.shapedirs.shape[-1], np.float32),
                                 query_res=cfg["query_posmap_size"], device=device)
    n, m = c.net, c.model
    net = AvatarNet(num_frames=x.n, pose_dim=x.pose.shape[1], c_geom=n.c_geom, c_pose=n.c_pose,
                    inp_posmap_size=m.inp_posmap_size, hsize=n.hsize, nf=n.nf,
                    geom_layer_type=n.geom_layer_type, up_mode=n.up_mode,
                    train_stage=m.train_stage,
                    compute_dtype="bfloat16" if n.bf16_decoder else "float32",
                    decoder_impl="fused" if n.fused_decoder else "ref",
                    pose_init=x.pose, transl_init=x.transl, init="torch", device=device)
    missing, unexpected = net.load_state_dict(x.weights, strict=False)
    params = {k for k, _ in net.named_parameters()}
    if unexpected or params & set(missing):
        raise RuntimeError(f"the benchmark's weights do not fit the program's network: "
                           f"missing {sorted(params & set(missing))}, unexpected {unexpected}")
    return c, model.to(device), assets, net.eval()


def frame_items(x, cam: dict) -> list:
    """The training frames as the data layer's items: the frame index and
    the camera arrays the step reads."""
    return [{"pose_idx": np.int32(i), **{k: np.asarray(cam[k]) for k in CAMERA_KEYS}}
            for i in range(x.n)]


class _Quiet:
    def log_event(self, *a, **k):
        pass


def trainer(cfg: dict, mix: dict, x, seed: int, device, optimizer_cls=None):
    """The training side: the state at `mix['start_iteration']`, the need
    table built by the set-up probe, the S-step dispatch and the shuffled
    loader -> namespace(state, steps, loader, need, net, ...)."""
    from gaussianavatar_torch.data.dataset import BatchLoader
    from gaussianavatar_torch.engine import need_table
    from gaussianavatar_torch.engine.optim import build_optimizer
    from gaussianavatar_torch.engine.setup import AvatarBundle
    from gaussianavatar_torch.engine.train_step import TrainState, make_train_steps
    from gaussianavatar_torch.ops.rasterize import raster_config

    c, model, assets, net = avatar(cfg, x, device)
    items = frame_items(x, x.cam)
    bundle = AvatarBundle(model, assets, net, items)
    B = c.model.batch_size
    loader = BatchLoader(items, B, seed=seed)
    H = W = x.size
    inp_bank = x.posmaps if c.model.train_stage == 2 else None
    raster = raster_config(c, train=True)
    need = need_table.NeedTable(c, bundle, items, raster, H, W, inp_bank=inp_bank)
    need_table.update([need], [_Quiet()])
    net.train()
    opt = build_optimizer(net, c.opt, len(loader), c.model.train_stage)
    if optimizer_cls is not None:
        opt = optimizer_cls(opt.groups)
    state = TrainState(net, opt, iteration=int(mix["start_iteration"]))
    spd = int(c.opt.steps_per_dispatch)
    bg = (1.0, 1.0, 1.0) if c.model.white_background else (0.0, 0.0, 0.0)
    steps = make_train_steps(net, model, assets, c.opt, H, W, bg, need.config(), x.gt, spd,
                             train_stage=c.model.train_stage, inp_bank=inp_bank,
                             need_caps=need.caps)
    return SimpleNamespace(cfg=c, state=state, steps=steps, loader=loader, need=need, net=net,
                           spd=spd, per_epoch=len(loader), assets=assets,
                           retune=lambda epoch: need_table.update([need], [_Quiet()], epoch))


def snapshot(tr) -> tuple:
    """Copies of the trainer's starting state: the network's parameters and
    buffers, the optimizer's moments and counts, the iteration."""
    net = {k: v.detach().clone() for k, v in tr.net.state_dict().items()}
    opt = {g: {k: ({n: t.detach().clone() for n, t in v.items()} if isinstance(v, dict)
                   else (v.detach().clone() if torch.is_tensor(v) else v))
               for k, v in sd.items()}
           for g, sd in tr.state.optimizer.state_dict().items()}
    return net, opt, tr.state.iteration


@torch.no_grad()
def restore(tr, snap: tuple):
    """Put a `snapshot` back into the trainer's own tensors, in place (the
    captured graph reads them), and re-probe the need table from it as the
    set-up probe did, refilling its caps in place."""
    from gaussianavatar_torch.engine import need_table

    net, opt, iteration = snap
    for k, v in tr.net.state_dict().items():
        v.copy_(net[k])
    tr.state.optimizer.load_state_dict(opt)
    tr.state.iteration = iteration
    need_table.update([tr.need], [_Quiet()])


def renderer(cfg: dict, x, device):
    """The rendering side: `make_renderer` over the network in eval mode
    (stage 1 decodes its canonical cache here, once)."""
    from gaussianavatar_torch.engine.inference import InferenceBundle, make_renderer
    from gaussianavatar_torch.engine.setup import AvatarBundle

    c, model, assets, net = avatar(cfg, x, device)
    inf = InferenceBundle(c, AvatarBundle(model, assets, net, None), epoch=0)
    return SimpleNamespace(render=make_renderer(inf, x.size, x.size), net=net, assets=assets)


def w_rgl(cfg: dict, epoch: int) -> float:
    """The offset regulariser's weight at `epoch`, as the training loop
    decays it (x 0.85 every 20 epochs)."""
    from gaussianavatar_torch.engine.loop import adjust_loss_weights

    return adjust_loss_weights(cfg["opt"]["lambda_rgl"], epoch, "decay", 0, 20)


def optimizer_base():
    from gaussianavatar_torch.engine.optim import GroupOptimizer

    return GroupOptimizer


def launches() -> dict:
    from gaussianavatar_torch.utils.cuda_build import LAUNCHES

    return dict(LAUNCHES)
