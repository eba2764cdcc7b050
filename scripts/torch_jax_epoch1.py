"""The port's first epoch from flax's initial network, held against the
JAX package's step by step on the CPU (ROADMAP F20).

Both packages start from one JAX `init_state(..., rng=PRNGKey(K))`
(`--jax_key K`, 0 by default), carried into the port by
`gaussianavatar_torch.bridge` (flax's initialisation on both sides), and
train one epoch of the quality gate's synthetic subject
(48 train frames, `body_kwargs` n_rings 48, n_cols 32; B=2, so 24 steps)
with the campaign's schedules (`--epochs 200`), the need table and the
footprint M=9 on both sides:

- JAX: `make_train_step` (jitted; the ragged Pallas kernels in interpret
  mode, as the JAX package's CPU tests run them), caps and the chunk
  budget from its loop's `make_counts_fn` and `build_need_bank` rule
  (gaussianavatar_tpu/engine/loop.py:278-326), the probe's blend in
  interpret mode too;
- the port: `make_train_step` with `need_caps`, the probe of
  `engine/need_table.NeedTable`.

Every step of every run is fed the same caps table, the JAX f32 probe's at
startup, so that a difference in the probes cannot hide a difference in
training. The runs: the port at f32 (`--bf16_decoder 0`), JAX at f32 and,
as the control, JAX at bf16 from the same weights over the same batches;
three more controls, JAX at f32 from the initial weights times
(1 + 1e-4 N(0, 1)) (seeds 1-3), read how far JAX's own trajectory spreads
from rounding-sized causes; and the anchored run, which at every step of
JAX's f32 trajectory runs the port's step from JAX's own state and holds
the port's gradient, update and BatchNorm statistics against JAX's: the
step map itself, with no chaos in between.

Recorded after each step 1..24: every loss term, the raw scale output's
p50 / p99 / max and mean over the valid points (the training-mode decode the step
ran, before the warm-up), the warm-up factor, the (gaussian, tile) pairs
the footprint clipped (`m_dropped`, from each package's `footprint_drop`
on the step's gaussians) and the pairs the caps cut (`truncated`, the
step's overflow less `m_dropped`), and every BatchNorm layer's running mean
and variance. After steps 8, 16 and 24 also the eval-mode decode's scale
quantiles and each package's own probe: the clip fraction at M=4, the mean
need and the drift against the startup caps (after step 24 that probe is
the epoch-1 retune). At the retune the port's probe also reads JAX's
state, which separates the probes from the training.

The band: for each quantity the distance JAX's bf16 run keeps from JAX's
f32 run, its largest up to that step (rounding chaos only grows); the wide
band takes the perturbed controls' distances too. A quantity's distance is
relative, |a - b| / max(|b|, floor), the largest element for a vector;
counts of pairs take a floor of one pair. The script prints the first step
and quantity at which the port's f32 run leaves JAX's f32 run by more than
the band (and by more than NOISE, float32 noise, where the control does not
move the quantity), the same against the wide band, and the anchored run's
largest distances, then one JSON line.

    python3 scripts/torch_jax_epoch1.py --work output/f20 --out docs/f20 \
        [--image 256 --tile 16 --query 512 --inp 128 --hsize 128 --c_geom 64]
    python3 scripts/torch_jax_epoch1.py ... --runs jax_f32     # JAX's trail only
    python3 scripts/torch_jax_epoch1.py ... --jax_key 1        # from PRNGKey(1)
    python3 scripts/torch_jax_epoch1.py ... --loader_seed 1    # train_multi subject 1's order
    python3 scripts/torch_jax_epoch1.py ... --runs step1       # step 1, capped and not

At 256^2 with 16 px tiles the canonical footprint in tiles is kept (512^2
at 32 px). A JAX run takes 8-14 minutes on 4 cores and 2-3 GB; the runs
are independent (start several processes with one run each).

Each run is kept under `<work>/<size>/` (`--runs` picks them; the compare
reads what is there), so the runs can be made in separate processes.
Writes `<out>/epoch1_<size>.json` (every record and distance) and
`<out>/epoch1_<size>.txt` (the table). These runs import both packages, so
they run on the CPU.

    python3 scripts/torch_jax_epoch1.py --device cuda --image 512 --tile 32 \
        --init_pkl <work>/<size>/init.pkl [--card bf16_jaxinit ...] [--port_seed N]

runs the port alone on the card (no JAX there): one epoch per variant, the
f32 or bf16 decoder, from the JAX initial weights a CPU run wrote
(`init.pkl`, any image size at the same widths; `--perturb_seed N`: as the
control jax_f32_pN perturbs them) or from the port's own `--init flax`
draw, with the same readings; `<out>/card_<size>.json`.
"""

import argparse
import functools
import json
import math
import os
import pickle
import resource
import sys
import time
from os.path import join

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

B = 2
N_TRAIN, N_TEST = 48, 8
BODY_KWARGS = {"n_rings": 48, "n_cols": 32}   # the quality gate's subject
STEPS = N_TRAIN // B                          # one epoch
CHECKPOINTS = (8, 16, 24)
M_FULL, M_CAND = 9, 4
RUNS = ("jax_f32", "jax_bf16", "port_f32")
# JAX f32 from the initial weights times (1 + PERTURB N(0, 1)), one seed each
CONTROLS = ("jax_f32_p1", "jax_f32_p2", "jax_f32_p3")
PERTURB = 1e-4
ALL_RUNS = RUNS + CONTROLS + ("anchored",)
TERMS = ("l1", "ssim", "scale", "offset", "geo", "total", "raster_overflow")
# the quantities counted in pairs: their distance has a floor of one pair
COUNTS = ("raster_overflow", "m_dropped", "truncated")
# float32 noise: the two packages pose the gaussians with LBS summed in
# other orders, so no distance below this parts them, whatever the band
NOISE = 1e-4
# the JAX config's train_footprint_eps: the retune's M=4 threshold
FOOTPRINT_EPS = 1e-3


def size_name(a) -> str:
    """The size's name; a JAX key or a loader seed other than 0 is added to it."""
    key, seed = getattr(a, "jax_key", 0), getattr(a, "loader_seed", 0)
    return (f"img{a.image}_t{a.tile}_q{a.query}_i{a.inp}_h{a.hsize}_c{a.c_geom}"
            + (f"_jaxkey{key}" if key else "") + (f"_loader{seed}" if seed else ""))


def cli_flags(a, data, bf16: int):
    """The training flags both packages' parsers take."""
    return ["-s", data, "-m", join(a.work, "unused"), "--dataset_type", "synthetic",
            "--query_posmap_size", str(a.query), "--inp_posmap_size", str(a.inp),
            "--batch_size", str(B), "--epochs", "200", "--hsize", str(a.hsize),
            "--c_geom", str(a.c_geom), "--tile_size", str(a.tile),
            "--max_tiles_per_gaussian", str(M_FULL), "--bf16_decoder", str(bf16),
            "--ragged", "1", "--auto_cascade", "1"]


def perturbed(tree, seed: int):
    """A numpy tree of JAX parameters times (1 + PERTURB N(0, 1)), float32,
    drawn leaf by leaf in sorted key order: JaxRun's `perturb_seed` on its
    `jax.tree.map`, value for value, with no JAX."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return np.asarray(t) * (1.0 + PERTURB * rng.standard_normal(np.shape(t))).astype(
            np.float32)
    return walk(tree)


def quantiles(x: np.ndarray) -> dict:
    x = np.asarray(x, np.float64).reshape(-1)
    return {"p50": float(np.quantile(x, 0.5)), "p99": float(np.quantile(x, 0.99)),
            "max": float(x.max())}


def epoch_order(seed: int = 0):
    """Epoch 1's batches: the first permutation of a loader seeded `seed`
    (0 in `train`; subject s of `train_multi` is seeded s)."""
    order = np.random.default_rng(seed).permutation(N_TRAIN)
    return [order[i * B:(i + 1) * B] for i in range(STEPS)]


def need_summary(raw: np.ndarray, clip, startup_caps, margin: float, capacity: int) -> dict:
    """A probe's readings: the M=4 clip fraction, the mean raw need, the mean
    cap after the margin (what the JAX loop prints as `mean need`) and the
    drift against the startup caps (the pairs whose need outgrew them)."""
    caps = np.minimum(np.ceil(raw * margin), capacity)
    out = {"clip_frac_m4": float(clip[0]) / max(float(clip[1]), 1.0),
           "mean_need": float(raw.mean()), "mean_cap": float(caps.mean())}
    if startup_caps is not None:
        out["drift"] = float(np.maximum(raw - startup_caps, 0).sum()) / max(float(raw.sum()), 1.0)
    return out


# --------------------------------------------------------------------------
# JAX
# --------------------------------------------------------------------------

class JaxRun:
    """The JAX package's training state, step, probe and readings."""

    def __init__(self, a, data, bf16: int, perturb_seed: int = 0):
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_platforms", "cpu")
        from gaussianavatar_tpu import config as jc
        from gaussianavatar_tpu.data.dataset import collate
        from gaussianavatar_tpu.engine.inference import PROBE_CAPACITY, make_counts_fn
        from gaussianavatar_tpu.engine.loop import raster_config
        from gaussianavatar_tpu.engine.optim import build_optimizer
        from gaussianavatar_tpu.engine.setup import setup_avatar
        from gaussianavatar_tpu.engine.train_step import (
            _forward_gaussians, init_state, make_train_step,
        )
        from gaussianavatar_tpu.ops.projection import project_gaussians
        from gaussianavatar_tpu.ops.rasterize_tile import footprint_drop

        self.jax, self.jnp = jax, jnp
        self.capacity = PROBE_CAPACITY
        cfg = jc.extract_config(jc.build_parser().parse_args(cli_flags(a, data, bf16)))
        self.cfg = cfg
        bundle = setup_avatar(cfg, train=True)
        self.bundle = bundle
        ds = bundle.train_dataset
        self.F = len(ds)
        item = ds[0]
        H, W = int(item["height"]), int(item["width"])
        self.H, self.W = H, W
        self.ts = cfg.raster.tile_size
        self.T = math.ceil(W / self.ts) * math.ceil(H / self.ts)
        self.margin = float(cfg.raster.ragged_margin or 1.5)
        drop = {"FovX", "FovY", "height", "width", "projection_matrix", "camera_center",
                "original_image"}
        self.items = [{k: v for k, v in ds[i].items() if k not in drop} for i in range(self.F)]
        self.collate = collate
        self.gt = np.stack([np.clip(np.rint(ds[i]["original_image"] * 255.0), 0, 255)
                            .astype(np.uint8) for i in range(self.F)])

        class _TX0:
            def init(self, p):
                return None

        state = init_state(bundle.net, bundle.assets, _TX0(),
                           rng=jax.random.PRNGKey(getattr(a, "jax_key", 0)), batch_size=B)
        if perturb_seed:
            rng = np.random.default_rng(perturb_seed)
            state = state.replace(params=jax.tree.map(
                lambda x: jnp.asarray(np.asarray(x) * (1.0 + PERTURB * rng.standard_normal(
                    np.shape(x))).astype(np.float32)), state.params))
        self.tx = build_optimizer(state.params, cfg.opt, self.F // B, 1)
        self.state = state.replace(opt_state=self.tx.init(state.params))
        self.rcfg = raster_config(cfg, train=True)
        # the probe's blend in interpret mode (the XLA form holds every
        # tile's 4096 rows at once)
        self.rcfg_probe = self.rcfg._replace(backend="pallas_interpret")
        self.counts_fn = make_counts_fn(bundle, H, W, self.rcfg_probe,
                                        probe_capacity=PROBE_CAPACITY, cand_m=M_CAND)
        net, body, assets = bundle.net, bundle.body_model, bundle.assets
        ts = self.ts

        @functools.partial(jax.jit, static_argnums=2)
        def decode_scales(params, stats, train):
            variables = {"params": params, "batch_stats": stats}
            if train:
                out, _ = net.apply(variables, method=lambda m: m.decode(assets, 1, train=True),
                                   mutable=["batch_stats"])
            else:
                out = net.apply(variables, method=lambda m: m.decode(assets, 1, train=False))
            return out[1][0, :assets.num_valid, 0]

        @jax.jit
        def m_dropped(params, stats, batch, iteration):
            variables = {"params": params, "batch_stats": stats}
            world, _, scales3, rotations, opacity, _, _ = _forward_gaussians(
                net, variables, body, assets, batch, iteration, True, True)
            rot = jnp.broadcast_to(rotations[None], (B,) + rotations.shape)
            opac = jnp.broadcast_to(opacity.reshape(1, -1), (B, opacity.shape[-1]))
            projs = jax.vmap(lambda m, s, r, wvt, fpt, tx, ty: project_gaussians(
                m, s, r, wvt, fpt, tx, ty, H, W))(
                world, scales3, rot, batch["world_view_transform"],
                batch["full_proj_transform"], batch["tan_fovx"], batch["tan_fovy"])
            return footprint_drop(projs, opac, H, W, ts, M_FULL)

        self.decode_scales = lambda train: np.asarray(
            decode_scales(self.state.params, self.state.batch_stats, train))
        self._m_dropped = m_dropped
        self._make_step = lambda rcfg, tx=None: make_train_step(
            net, body, assets, self.tx if tx is None else tx, cfg.opt, H, W,
            (1.0, 1.0, 1.0) if cfg.model.white_background else (0.0, 0.0, 0.0), rcfg,
            train_stage=1, gt_bank=jnp.asarray(self.gt))
        self.step_fn = None

    def batch(self, idxs):
        b = self.collate([self.items[int(i)] for i in idxs])
        return {k: self.jnp.asarray(v) for k, v in b.items()}

    def probe(self, state=None):
        """The JAX loop's probe over every frame, B at a time, the last batch
        wrapping (loop.py:278-310) -> (raw needs (F, T), [clipped, all] pairs
        at M=4)."""
        st = self.state if state is None else state
        raw = np.zeros((self.F, self.T), np.int64)
        got = np.zeros(self.F, bool)
        clip = np.zeros(2, np.int64)
        for i in range(0, self.F, B):
            idxs = [(i + j) % self.F for j in range(B)]
            out = self.counts_fn(st.params, st.batch_stats, self.batch(idxs))
            needed = np.asarray(out[1]).reshape(B, self.T)
            clip += [int(out[2]), int(out[3])]
            for row, k in zip(needed, idxs):
                if not got[k]:
                    raw[k] = row
                    got[k] = True
        return raw, clip

    def set_caps(self, caps: np.ndarray):
        """The caps every step is fed, and the loop's chunk budget for them
        (loop.py:312-318); the step is built for them."""
        CB = int(self.rcfg.ragged_chunk)
        ch = (-(-caps.astype(np.int64) // CB)).sum(axis=1)
        top = int(np.sort(ch)[::-1][:B].sum())
        C = int(top * 1.15) + B
        C = -(-C // 256) * 256 if C >= 256 else -(-C // 8) * 8
        budget = int(np.ceil(C * CB / (B * self.T)))
        self.caps = caps.astype(np.int32)
        self.step_fn = self._make_step(self.rcfg._replace(ragged_budget=budget))
        self.budget = budget
        return budget

    def gradients(self, idxs, w_rgl, pose_gate):
        """JAX's gradient at the current state on this batch (an optax
        transformation that applies nothing and keeps the gradient), the
        state left as it was; -> the gradient as the port's state_dict."""
        import optax
        from gaussianavatar_torch import bridge
        jax, jnp = self.jax, self.jnp
        if not hasattr(self, "_grad_step"):
            self._rec = optax.GradientTransformation(
                lambda p: jax.tree.map(jnp.zeros_like, p),
                lambda g, st, p=None: (jax.tree.map(jnp.zeros_like, g), g))
            self._grad_step = self._make_step(self.rcfg._replace(ragged_budget=self.budget),
                                              self._rec)
        st = jax.tree.map(lambda x: jnp.array(x), self.state)   # the step donates its state
        st = st.replace(opt_state=self._rec.init(st.params))
        b = self.batch(idxs)
        b["tile_caps"] = jnp.asarray(self.caps[np.asarray(idxs)])
        st, _, _ = self._grad_step(st, b, jnp.float32(w_rgl), jnp.float32(pose_gate),
                                   jnp.float32(0.0))
        _, stats = self.trees()
        return bridge.state_dict_from_jax(jax.tree.map(np.asarray, st.opt_state), stats)

    def state_dict(self):
        from gaussianavatar_torch import bridge
        return bridge.state_dict_from_jax(*self.trees())

    def step(self, idxs, w_rgl, pose_gate):
        jnp = self.jnp
        b = self.batch(idxs)
        it = int(self.state.iteration) + 1
        drop, _ = self._m_dropped(self.state.params, self.state.batch_stats, b, jnp.int32(it))
        b["tile_caps"] = jnp.asarray(self.caps[np.asarray(idxs)])
        self.state, terms, _ = self.step_fn(self.state, b, jnp.float32(w_rgl),
                                            jnp.float32(pose_gate), jnp.float32(0.0))
        return {k: float(v) for k, v in terms.items()}, int(drop)

    def warmup(self, it: int) -> float:
        from gaussianavatar_tpu.models.avatar import scale_warmup
        return float(scale_warmup(self.jnp.ones((1,), self.jnp.float32), self.jnp.int32(it))[0])

    def trees(self):
        return (self.jax.tree.map(np.asarray, self.state.params),
                self.jax.tree.map(np.asarray, self.state.batch_stats))

    def bn_stats(self) -> dict:
        from gaussianavatar_torch import bridge
        params, stats = self.trees()
        sd = bridge.state_dict_from_jax({}, stats)
        return {k: v.numpy().astype(np.float64) for k, v in sd.items()}


# --------------------------------------------------------------------------
# The port
# --------------------------------------------------------------------------

class PortRun:
    """The port's training state, step, probe and readings, on `device`
    (the CPU beside JAX; the card in `--device cuda`), at the f32 decoder
    unless `bf16`; from JAX's `params` and `stats` (numpy trees), or, with
    None, from the port's own `--init flax` draw (generator seed `seed`)."""

    def __init__(self, a, data, params, stats, device="cpu", bf16=0, seed=0):
        from gaussianavatar_torch import bridge
        from gaussianavatar_torch.config import build_parser, extract_config
        from gaussianavatar_torch.data.dataset import collate
        from gaussianavatar_torch.engine import need_table
        from gaussianavatar_torch.engine.loop import DROP_KEYS, build_gt_bank
        from gaussianavatar_torch.engine.optim import build_optimizer
        from gaussianavatar_torch.engine.setup import setup_avatar
        from gaussianavatar_torch.engine.train_step import TrainState, make_train_step
        from gaussianavatar_torch.ops.rasterize import raster_config

        self.device = device
        cfg = extract_config(build_parser().parse_args(cli_flags(a, data, bf16)))
        bundle = setup_avatar(cfg, device=device, train=True, init="flax", seed=seed)
        self.bundle, self.net = bundle, bundle.net
        ds = bundle.frames
        self.F = len(ds)
        H, W = ds.image_hw()
        self.H, self.W = H, W
        self.collate = collate
        self.items = [{k: v for k, v in ds[i].items() if k not in DROP_KEYS | {"original_image"}}
                      for i in range(self.F)]
        gt_bank = build_gt_bank(ds, device)
        self.net.train()
        optimizer = build_optimizer(self.net, cfg.opt, self.F // B, 1)
        if params is None:
            self.state = TrainState(self.net, optimizer, 0)
        else:
            self.state = bridge.train_state_from_jax(self.net, optimizer, params, stats, 0)
        rcfg = raster_config(cfg, train=True)
        self.table = need_table.NeedTable(cfg, bundle, ds, rcfg, H, W, drop=DROP_KEYS)
        self.ts = rcfg.tile_size
        self.margin = self.table.margin
        self.capacity = need_table.PROBE_CAPACITY
        self.caps = torch.zeros((self.F, self.table.T), dtype=torch.int32, device=device)
        self.step_fn = make_train_step(
            self.net, bundle.body_model, bundle.assets, cfg.opt, H, W,
            (1.0, 1.0, 1.0) if cfg.model.white_background else (0.0, 0.0, 0.0),
            self.table.config(), gt_bank, need_caps=self.caps)

    def batch(self, idxs):
        return self.collate([self.items[int(i)] for i in idxs])

    @torch.no_grad()
    def decode_scales(self, train: bool) -> np.ndarray:
        mode = self.net.training
        self.net.train(train)
        try:
            scales = self.net.decode(self.bundle.assets, 1)[1]
        finally:
            self.net.train(mode)
        return scales[0, :self.bundle.assets.num_valid, 0].float().cpu().numpy()

    @torch.no_grad()
    def m_dropped(self, idxs, iteration: int) -> int:
        from gaussianavatar_torch.engine.inference import _to_device, posed_gaussians
        from gaussianavatar_torch.ops.projection import project_gaussians
        from gaussianavatar_torch.ops.rasterize_tile import footprint_drop

        b = _to_device(self.batch(idxs), self.device)
        res, scales, shs, _ = self.net.decode(self.bundle.assets, 1)
        res, scales, shs = (x.expand(B, -1, -1) for x in (res, scales, shs))
        world, _, scales3, rot, opac = posed_gaussians(
            self.net, self.bundle.body_model, self.bundle.assets, res, scales, shs, b, iteration)
        N = world.shape[1]
        projs = project_gaussians(world, scales3, rot[None].expand(B, N, 4),
                                  b["world_view_transform"], b["full_proj_transform"],
                                  b["tan_fovx"].reshape(B), b["tan_fovy"].reshape(B),
                                  self.H, self.W)
        drop, _ = footprint_drop(projs, opac.reshape(1, N).expand(B, N), self.H, self.W,
                                 self.ts, M_FULL)
        return int(drop)

    def step(self, idxs, w_rgl, pose_gate):
        drop = self.m_dropped(idxs, self.state.iteration + 1)
        terms, _ = self.step_fn(self.state, self.batch(idxs), w_rgl, pose_gate, 0.0)
        return {k: float(v) for k, v in terms.items()}, drop

    def probe(self):
        raw, clip = self.table.probe()
        return raw.cpu().numpy(), clip.cpu().numpy()

    def load(self, sd, iteration: int):
        """The network set to `sd` (a JAX state through the bridge) at
        `iteration`; the optimizer keeps its own moments."""
        self.net.load_state_dict(sd)
        self.state.iteration = iteration

    def probe_state(self, params, stats):
        """The port's probe on another state (JAX's, through the bridge);
        the run's own state is put back."""
        from gaussianavatar_torch import bridge
        keep = {k: v.clone() for k, v in self.net.state_dict().items()}
        self.net.load_state_dict(bridge.state_dict_from_jax(params, stats))
        try:
            return self.probe()
        finally:
            self.net.load_state_dict(keep)

    def warmup(self, it: int) -> float:
        from gaussianavatar_torch.models.avatar import scale_warmup
        return float(scale_warmup(torch.ones(1), torch.tensor(it, dtype=torch.int32))[0])

    def startup_caps(self):
        """The port's own startup probe -> (raw needs, clip, caps)."""
        raw, clip = self.probe()
        caps = np.minimum(np.ceil(raw * self.margin), self.capacity).astype(np.int32)
        return raw, clip, caps

    def bn_stats(self) -> dict:
        return {k: v.cpu().numpy().astype(np.float64) for k, v in self.net.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}


# --------------------------------------------------------------------------
# The runs
# --------------------------------------------------------------------------

def write_data(a, data):
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    if not os.path.exists(join(data, "train", "smpl_parms.pth")):
        write_synthetic_dataset(data, n_train=N_TRAIN, n_test=N_TEST, image_size=a.image,
                                body_kwargs=BODY_KWARGS, device=a.device)


def init_run(a, work, data):
    """JAX's initial state and its f32 startup probe -> init.pkl (the
    weights both packages start from, the caps every run is fed)."""
    path = join(work, "init.pkl")
    if os.path.exists(path):
        return pickle.load(open(path, "rb"))
    t0 = time.time()
    run = JaxRun(a, data, bf16=0)
    raw, clip = run.probe()
    caps = np.minimum(np.ceil(raw * run.margin), run.capacity).astype(np.int32)
    params, stats = run.trees()
    init = {"params": params, "stats": stats, "raw": raw, "clip": clip, "caps": caps,
            "margin": run.margin, "capacity": run.capacity, "T": run.T,
            "startup": need_summary(raw, clip, None, run.margin, run.capacity),
            "seconds": time.time() - t0}
    pickle.dump(init, open(path, "wb"))
    return init


def epoch1(run, name, caps, margin, capacity, loader_seed=0):
    """One epoch of `run` (JaxRun or PortRun) fed `caps` -> its records:
    per step the readings, and at CHECKPOINTS the eval-mode scales and the
    run's own probe (drift against `caps`)."""
    from gaussianavatar_torch.config import OptimizationParams
    from gaussianavatar_torch.engine.loop import adjust_loss_weights, pose_opt_gate_value

    t0 = time.time()
    opt = OptimizationParams(epochs=200)
    w_rgl = adjust_loss_weights(opt.lambda_rgl, 1, "decay", 0, 20)
    gate = pose_opt_gate_value(1, 1, opt)
    steps, checks = [], {}
    for s, idxs in enumerate(epoch_order(loader_seed), start=1):
        scales = run.decode_scales(True)
        terms, drop = run.step(idxs, w_rgl, gate)
        rec = {"step": s, **{k: terms[k] for k in TERMS},
               **{f"scale_{k}": v for k, v in quantiles(scales).items()},
               "scale_mean": float(scales.mean()),
               "warmup": run.warmup(s), "m_dropped": drop,
               "truncated": terms["raster_overflow"] - drop, "bn": run.bn_stats()}
        steps.append(rec)
        print(f"{name} step {s}: total {terms['total']:.6f} scale p50 {rec['scale_p50']:.4f} "
              f"m_dropped {drop} truncated {rec['truncated']:.0f} "
              f"({time.time() - t0:.0f} s)", flush=True)
        if s in CHECKPOINTS:
            raw, clip = run.probe()
            chk = {"eval_" + k: v for k, v in quantiles(run.decode_scales(False)).items()}
            chk.update(need_summary(raw, clip, caps, margin, capacity))
            if s == STEPS:
                chk["raw"] = raw
            checks[s] = chk
            print(f"{name} after step {s}: "
                  f"{json.dumps({k: v for k, v in chk.items() if k != 'raw'})}", flush=True)
    return {"steps": steps, "checks": checks, "seconds": time.time() - t0}


def train_run(a, work, data, name, init):
    path = join(work, f"{name}.pkl")
    if os.path.exists(path):
        return pickle.load(open(path, "rb"))
    if name == "port_f32":
        run = PortRun(a, data, init["params"], init["stats"])
        run.caps.copy_(torch.as_tensor(init["caps"]))
    else:
        seed = int(name[-1]) if name in CONTROLS else 0
        run = JaxRun(a, data, bf16=int(name == "jax_bf16"), perturb_seed=seed)
        budget = run.set_caps(init["caps"])
        print(f"{name}: chunk budget {budget} rows/tile", flush=True)
    out = epoch1(run, name, init["caps"], init["margin"], init["capacity"], a.loader_seed)
    if name == "jax_f32":
        out["state"] = run.trees()
    pickle.dump(out, open(path, "wb"))
    return out


def card_runs(a, data):
    """`--device cuda`: the port alone on the card (no JAX there), one
    epoch per variant at this size: the f32 and bf16 decoders, from JAX's
    initial weights (`--init_pkl`, written by a CPU run at the same widths)
    or from the port's own `--init flax` draw. Fed the init file's caps
    where its image and tile are this size's, else the run's own startup
    probe's. Writes `<out>/card_<size>.json`."""
    init = pickle.load(open(a.init_pkl, "rb")) if a.init_pkl else None
    same = init is not None and init["T"] == (a.image // a.tile) ** 2 and \
        f"img{a.image}_t{a.tile}_" in a.init_pkl
    out = {}
    for variant in a.card:
        prec, weights = variant.split("_")
        if weights == "jaxinit" and init is None:
            raise SystemExit(f"{variant} needs --init_pkl")
        params = init and (perturbed(init["params"], a.perturb_seed) if a.perturb_seed
                           else init["params"])
        run = PortRun(a, data, *((params, init["stats"]) if weights == "jaxinit"
                                 else (None, None)), device=a.device, bf16=int(prec == "bf16"),
                      seed=a.port_seed)
        raw, clip, caps = run.startup_caps()
        startup = need_summary(raw, clip, None, run.margin, run.capacity)
        if same and weights == "jaxinit":
            caps = init["caps"]
        run.caps.copy_(torch.as_tensor(caps))
        print(f"{variant}: startup probe {json.dumps(startup)}; caps from "
              f"{'the init file' if same and weights == 'jaxinit' else 'this probe'}", flush=True)
        rec = epoch1(run, variant, caps, run.margin, run.capacity, a.loader_seed)
        rec["startup"] = startup
        rec["checks"][STEPS].pop("raw", None)
        for r in rec["steps"]:
            r.pop("bn")
        out[variant] = rec
        del run
        if a.device != "cpu":
            torch.cuda.empty_cache()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    os.makedirs(a.out, exist_ok=True)
    json.dump({"size": size_name(a), "card": smi, "init_pkl": a.init_pkl,
               "port_seed": a.port_seed, "loader_seed": a.loader_seed,
               "perturb_seed": a.perturb_seed, "runs": out},
              open(join(a.out, f"card_{size_name(a)}{a.tag}.json"), "w"), indent=1)
    for v, rec in out.items():
        print(trail(v, rec))


def trail(name: str, rec) -> str:
    """A run's retune trail: the clip fraction at M=4 after steps 8 / 16 /
    24, the mean raw scale after steps 1 / 8 / 16 / 24, the drift at the
    retune and the footprint the JAX loop's rule picks there
    (gaussianavatar_tpu/engine/multi_loop.py:287-294: M 9 -> 4 where the
    clip fraction is at most `train_footprint_eps`)."""
    c = rec["checks"]
    clip = c[STEPS]["clip_frac_m4"]
    return (f"{name}: clip at M=4 " + " / ".join(f"{c[s]['clip_frac_m4']:.3g}"
                                                 for s in CHECKPOINTS)
            + "; mean raw scale " + " / ".join(f"{r['scale_mean']:.4f}" for r in rec["steps"]
                                               if r["step"] in (1,) + CHECKPOINTS)
            + f"; drift {c[STEPS]['drift']:.4f}; M {M_CAND if clip <= FOOTPRINT_EPS else M_FULL}")


def absorbed(name: str) -> bool:
    """A Dense bias that feeds a BatchNorm: its true gradient is exactly 0,
    so each package's is float noise (tests/test_torch_train.py)."""
    return (name.startswith("pop.decoder.dense.") and name.endswith(".bias")
            and name.split(".")[3] not in ("7", "10", "13"))


def grad_distance(p, j) -> float:
    """A port parameter's gradient against JAX's `j`: the largest
    difference over JAX's largest |gradient|."""
    g = torch.zeros_like(p) if p.grad is None else p.grad
    return float((g - j).abs().max()) / max(float(j.abs().max()), 1e-30)


def anchored_run(a, work, data, init):
    """At every step of JAX's f32 trajectory, the port's step from JAX's
    state (parameters, BatchNorm statistics, iteration; the port's Adam keeps
    its own moments, built from these steps): per step the largest relative
    distance of a gradient (of the leaf's largest |gradient|), of an update
    (|du_port - du_jax| / |du_jax|, L2 per leaf: Adam turns a near-zero
    gradient's float noise into a sign, so single elements flip), of a
    BatchNorm running statistic after the step, and of a loss term. The
    BatchNorm-absorbed Dense biases are left out (their gradient is noise)."""
    path = join(work, "anchored.pkl")
    if os.path.exists(path):
        return pickle.load(open(path, "rb"))
    from gaussianavatar_torch.config import OptimizationParams
    from gaussianavatar_torch.engine.loop import adjust_loss_weights, pose_opt_gate_value

    t0 = time.time()
    jax_run = JaxRun(a, data, bf16=0)
    jax_run.set_caps(init["caps"])
    port = PortRun(a, data, init["params"], init["stats"])
    port.caps.copy_(torch.as_tensor(init["caps"]))
    opt = OptimizationParams(epochs=200)
    w_rgl = adjust_loss_weights(opt.lambda_rgl, 1, "decay", 0, 20)
    gate = pose_opt_gate_value(1, 1, opt)
    steps = []
    for s, idxs in enumerate(epoch_order(a.loader_seed), start=1):
        before = jax_run.state_dict()
        j_grad = jax_run.gradients(idxs, w_rgl, gate)
        port.load(before, s - 1)
        t_terms, _ = port.step(idxs, w_rgl, gate)
        j_terms, _ = jax_run.step(idxs, w_rgl, gate)
        after, t_sd = jax_run.state_dict(), port.net.state_dict()
        rec = {"step": s, "grad": (0.0, ""), "update": (0.0, ""), "stat": (0.0, ""),
               "term": (0.0, "")}
        for n, p in port.net.named_parameters():
            if absorbed(n):
                continue
            d = grad_distance(p, j_grad[n])
            du_j, du_t = after[n] - before[n], t_sd[n] - before[n]
            u = float((du_t - du_j).norm()) / max(float(du_j.norm()), 1e-30)
            rec["grad"] = max(rec["grad"], (d, n))
            rec["update"] = max(rec["update"], (u, n))
        for n in after:
            if n.endswith(("running_mean", "running_var")):
                d = float((t_sd[n] - after[n]).abs().max()) / max(float(after[n].abs().max()),
                                                                  1e-30)
                rec["stat"] = max(rec["stat"], (d, n))
        for k in TERMS:
            d = distance(t_terms[k], j_terms[k], k in COUNTS)
            rec["term"] = max(rec["term"], (d, k))
        steps.append(rec)
        print(f"anchored step {s}: " + "; ".join(f"{k} {rec[k][0]:.2e} ({rec[k][1]})"
                                                 for k in ("grad", "update", "stat", "term"))
              + f" ({time.time() - t0:.0f} s)", flush=True)
    out = {"steps": steps, "seconds": time.time() - t0}
    pickle.dump(out, open(path, "wb"))
    return out


def step1_caps(a, work, data, init):
    """Step 1 from the initial state, the port's gradient against JAX's on
    the same batch, fed the startup caps and then `--step1_cap` rows a
    tile: per leaf the largest relative distance (the four worst), both
    packages' overflow counts and totals. Separates what the caps' cut
    does to a difference in the pairs binned from the step map itself."""
    path = join(work, f"step1_cap{a.step1_cap}.pkl")
    if os.path.exists(path):
        return pickle.load(open(path, "rb"))
    from gaussianavatar_torch.config import OptimizationParams
    from gaussianavatar_torch.engine.loop import adjust_loss_weights, pose_opt_gate_value

    opt = OptimizationParams(epochs=200)
    w_rgl = adjust_loss_weights(opt.lambda_rgl, 1, "decay", 0, 20)
    gate = pose_opt_gate_value(1, 1, opt)
    idxs = epoch_order(a.loader_seed)[0]
    out = {}
    for label, caps in (("startup", init["caps"]),
                        (f"cap{a.step1_cap}", np.full_like(init["caps"], a.step1_cap))):
        t0 = time.time()
        jax_run = JaxRun(a, data, bf16=0)
        jax_run.set_caps(caps)
        j_grad = jax_run.gradients(idxs, w_rgl, gate)
        port = PortRun(a, data, init["params"], init["stats"])
        port.caps.copy_(torch.as_tensor(caps))
        t_terms, _ = port.step(idxs, w_rgl, gate)
        j_terms, _ = jax_run.step(idxs, w_rgl, gate)
        worst = [(grad_distance(p, j_grad[n]), n) for n, p in port.net.named_parameters()
                 if not absorbed(n)]
        out[label] = {"grad": sorted(worst, reverse=True)[:4],
                      "overflow": (t_terms["raster_overflow"], j_terms["raster_overflow"]),
                      "total": (t_terms["total"], j_terms["total"]),
                      "seconds": time.time() - t0}
        print(f"step 1, {label} caps: " + json.dumps(out[label]), flush=True)
    pickle.dump(out, open(path, "wb"))
    return out


def cross_probe(a, work, data, init, jax_f32):
    """The port's probe on JAX f32's retune state, against JAX's probe
    there: both probes on one state."""
    path = join(work, "cross.pkl")
    if os.path.exists(path):
        return pickle.load(open(path, "rb"))
    port = PortRun(a, data, init["params"], init["stats"])
    raw, clip = port.probe_state(*jax_f32["state"])
    cross = need_summary(raw, clip, init["caps"], init["margin"], init["capacity"])
    jraw = jax_f32["checks"][STEPS]["raw"]
    cross["equal_cells"] = float((raw == jraw).mean())
    cross["max_gap"] = int(np.abs(raw - jraw).max())
    pickle.dump(cross, open(path, "wb"))
    return cross


# --------------------------------------------------------------------------
# The comparison
# --------------------------------------------------------------------------

def distance(a, b, count: bool) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    floor = 1.0 if count else 1e-12
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b).max(), floor)))


def step_quantities(rec) -> dict:
    q = {k: v for k, v in rec.items() if k not in ("step", "bn")}
    q.update({"bn:" + k: v for k, v in rec["bn"].items()})
    return q


def compare(runs) -> dict:
    """Per step and quantity: the port's distance from JAX f32, the band
    (JAX bf16 from JAX f32, its largest so far) and the wide band (the
    perturbed controls' too); the first parting against each, in step
    order, then quantity order."""
    ref, port, ctrl = runs["jax_f32"], runs["port_f32"], runs["jax_bf16"]
    controls = [runs[r] for r in CONTROLS if r in runs]
    table, band, wide, first, first_wide = [], {}, {}, None, None
    for s in range(STEPS):
        qr, qp, qc = (step_quantities(r["steps"][s]) for r in (ref, port, ctrl))
        qx = [step_quantities(r["steps"][s]) for r in controls]
        row = {}
        for k in qr:
            count = k in COUNTS
            d_port = distance(qp[k], qr[k], count)
            band[k] = max(band.get(k, 0.0), distance(qc[k], qr[k], count))
            wide[k] = max([wide.get(k, 0.0), band[k]] + [distance(q[k], qr[k], count)
                                                          for q in qx])
            row[k] = (d_port, band[k], wide[k])
            part = {"step": s + 1, "quantity": k, "port": d_port,
                    "jax_f32": qr[k] if np.ndim(qr[k]) == 0 else None,
                    "port_f32": qp[k] if np.ndim(qp[k]) == 0 else None}
            if first is None and d_port > max(band[k], NOISE):
                first = dict(part, band=band[k])
            if first_wide is None and d_port > max(wide[k], NOISE):
                first_wide = dict(part, band=wide[k])
        table.append(row)
    checks = {}
    for s in CHECKPOINTS:
        cs = {r: runs[r]["checks"][s] for r in RUNS + CONTROLS if r in runs}
        checks[s] = {k: {r: c[k] for r, c in cs.items()} for k in cs["jax_f32"] if k != "raw"}
    return {"table": table, "first": first, "first_wide": first_wide, "checks": checks}


def report(a, init, runs, cmp, cross, anchored, out_dir, step1=None):
    name = size_name(a)
    lines = [f"torch_jax_epoch1: {name}, B={B}, {STEPS} steps, M={M_FULL}, caps from the JAX "
             "f32 startup probe", ""]
    st = init["startup"]
    lines.append(f"startup probe (JAX f32): clip fraction at M=4 {st['clip_frac_m4']:.3e}, mean "
                 f"need {st['mean_need']:.3f}, mean cap {st['mean_cap']:.3f}")
    for r in RUNS + CONTROLS:
        if r in runs:
            c = runs[r]["checks"][STEPS]
            lines.append(f"epoch-1 retune ({r}): clip fraction at M=4 {c['clip_frac_m4']:.3e}, "
                         f"drift {c['drift']:.3e}, mean need {c['mean_need']:.3f}, eval scale "
                         f"p50 {c['eval_p50']:.4g} p99 {c['eval_p99']:.4g}")
    lines += ["", "trails:"] + ["  " + trail(r, runs[r]) for r in RUNS + CONTROLS if r in runs]
    if cross is not None:
        lines.append(f"the port's probe on JAX f32's retune state: clip fraction at M=4 "
                     f"{cross['clip_frac_m4']:.3e}, drift {cross['drift']:.3e}, mean need "
                     f"{cross['mean_need']:.3f}; needed depths equal JAX's on "
                     f"{cross['equal_cells']:.4f} of the cells, largest gap {cross['max_gap']}")
    lines.append("")
    lines.append("wall: " + ", ".join(f"{r} {runs[r]['seconds']:.0f} s" for r in runs)
                 + ("" if anchored is None else f", anchored {anchored['seconds']:.0f} s"))
    for label, rec in (step1 or {}).items():
        lines.append(f"step 1, {label} caps: overflow port / JAX {rec['overflow'][0]:.0f} / "
                     f"{rec['overflow'][1]:.0f}, total {rec['total'][0]:.7f} / "
                     f"{rec['total'][1]:.7f}; worst gradients " + ", ".join(
                         f"{d:.2e} ({n})" for d, n in rec["grad"]))
    if anchored is not None:
        lines += ["", "anchored: the port's step from JAX f32's state at each step, against "
                  "JAX's (largest relative distance, and where)"]
        for rec in anchored["steps"]:
            lines.append(f"  step {rec['step']:2d}: " + "; ".join(
                f"{k} {rec[k][0]:.2e} ({rec[k][1]})" for k in ("grad", "update", "stat", "term")))
    if cmp is not None:
        lines += ["", "free runs, per step: the port's distance from JAX f32 / the band (JAX "
                  "bf16) / the wide band (with the perturbed controls), the worst quantity of "
                  "each kind against the band"]
        kinds = {"terms": [k for k in TERMS], "scale": ["scale_p50", "scale_p99", "scale_max"],
                 "pairs": ["m_dropped", "truncated"], "bn": None}
        for s, row in enumerate(cmp["table"], start=1):
            parts = []
            for kind, keys in kinds.items():
                keys = keys or [k for k in row if k.startswith("bn:")]
                k = max(keys, key=lambda x: row[x][0] / max(row[x][1], NOISE))
                parts.append(f"{kind} {row[k][0]:.2e}/{row[k][1]:.2e}/{row[k][2]:.2e} ({k})")
            lines.append(f"  step {s:2d}: " + "; ".join(parts))
        names = [r for r in RUNS + CONTROLS if r in runs]
        lines += ["", "after steps 8, 16, 24: " + " | ".join(names)]
        for s, chk in cmp["checks"].items():
            for k, v in chk.items():
                lines.append(f"  {s:2d} {k:13s} " + " | ".join(f"{v[r]:.4g}" for r in names))
        lines.append("")
        for label, f in (("band", cmp["first"]), ("wide band", cmp["first_wide"])):
            lines.append(f"first parting against the {label}: " + (
                f"step {f['step']}, {f['quantity']}: the port's distance {f['port']:.3e} against "
                f"{f['band']:.3e}" if f else f"none: the port stays within it for all {STEPS} "
                "steps"))
    text = "\n".join(lines)
    os.makedirs(out_dir, exist_ok=True)
    open(join(out_dir, f"epoch1_{name}.txt"), "w").write(text + "\n")

    def plain(x):
        if isinstance(x, dict):
            return {str(k): plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        if isinstance(x, np.ndarray):
            return x.tolist()
        if isinstance(x, (np.floating, np.integer)):
            return x.item()
        return x

    records = {r: {"seconds": runs[r]["seconds"],
                   "steps": [{k: v for k, v in rec.items() if k != "bn"}
                             for rec in runs[r]["steps"]],
                   "checks": {s: {k: v for k, v in c.items() if k != "raw"}
                              for s, c in runs[r]["checks"].items()}} for r in runs}
    blob = {"size": {k: v for k, v in vars(a).items() if k not in ("work", "out", "runs")},
            "startup": st, "runs": records, "cross_probe": cross, "anchored": anchored,
            "step1": step1,
            "distances": None if cmp is None else
            [{k: {"port": v[0], "band": v[1], "wide_band": v[2]} for k, v in row.items()}
             for row in cmp["table"]],
            "first_parting": None if cmp is None else cmp["first"],
            "first_parting_wide": None if cmp is None else cmp["first_wide"]}
    json.dump(plain(blob), open(join(out_dir, f"epoch1_{name}.json"), "w"), indent=1)
    print(text)
    return blob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=join(REPO, "output", "f20"))
    ap.add_argument("--out", default=join(REPO, "docs", "f20"))
    ap.add_argument("--image", type=int, default=256)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--query", type=int, default=512)
    ap.add_argument("--inp", type=int, default=128)
    ap.add_argument("--hsize", type=int, default=128)
    ap.add_argument("--c_geom", type=int, default=64)
    ap.add_argument("--runs", nargs="*", default=list(ALL_RUNS), choices=ALL_RUNS + ("step1",),
                    help="step1 (not run by default): step1_caps's two gradient comparisons")
    ap.add_argument("--step1_cap", type=int, default=2048)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--card", nargs="+", default=["f32_jaxinit", "bf16_jaxinit",
                                                  "f32_portinit", "bf16_portinit"],
                    choices=["f32_jaxinit", "bf16_jaxinit", "f32_portinit", "bf16_portinit"])
    ap.add_argument("--init_pkl", default=None)
    ap.add_argument("--port_seed", type=int, default=0)
    ap.add_argument("--perturb_seed", type=int, default=0,
                    help="card mode: the *_jaxinit variants start from JAX's weights perturbed "
                         "as the control jax_f32_pN is, N the seed (0: unperturbed)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--jax_key", type=int, default=0,
                    help="JAX's initial network is init_state(PRNGKey(K)); K > 0 tags the "
                         "work directory and the outputs _jaxkeyK")
    ap.add_argument("--loader_seed", type=int, default=0,
                    help="epoch 1's batch order is a loader's seeded L (train_multi's subject "
                         "L's); L > 0 tags the work directory and the outputs _loaderL")
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)
    work = join(a.work, size_name(a))
    data = join(a.work, f"data_img{a.image}")
    os.makedirs(work, exist_ok=True)
    write_data(a, data)
    if a.device != "cpu":
        return card_runs(a, data)
    init = init_run(a, work, data)
    runs = {r: train_run(a, work, data, r, init) for r in a.runs
            if r not in ("anchored", "step1")}
    step1 = step1_caps(a, work, data, init) if "step1" in a.runs else None
    if step1 is None and os.path.exists(join(work, f"step1_cap{a.step1_cap}.pkl")):
        step1 = pickle.load(open(join(work, f"step1_cap{a.step1_cap}.pkl"), "rb"))
    anchored = anchored_run(a, work, data, init) if "anchored" in a.runs else None
    # what earlier processes left for the other runs
    for r in RUNS + CONTROLS:
        if r not in runs and os.path.exists(join(work, f"{r}.pkl")):
            runs[r] = pickle.load(open(join(work, f"{r}.pkl"), "rb"))
    if anchored is None and os.path.exists(join(work, "anchored.pkl")):
        anchored = pickle.load(open(join(work, "anchored.pkl"), "rb"))
    # the cross probe runs beside the port's own run, or in a compare-only call
    cross = None
    if "jax_f32" in runs and ("port_f32" in a.runs or not a.runs
                              or os.path.exists(join(work, "cross.pkl"))):
        cross = cross_probe(a, work, data, init, runs["jax_f32"])
    cmp = compare(runs) if all(r in runs for r in RUNS) else None
    blob = report(a, init, runs, cmp, cross, anchored, a.out, step1)
    print(json.dumps({"size": size_name(a), "startup_clip_m4": init["startup"]["clip_frac_m4"],
                      "retune_clip_m4": {r: runs[r]["checks"][STEPS]["clip_frac_m4"]
                                         for r in runs},
                      "first_parting": blob["first_parting"],
                      "first_parting_wide": blob["first_parting_wide"],
                      "anchored_max": None if anchored is None else {
                          k: max(rec[k][0] for rec in anchored["steps"])
                          for k in ("grad", "update", "stat", "term")},
                      "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}))


if __name__ == "__main__":
    main()
