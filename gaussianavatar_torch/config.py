"""Typed configuration: the port's own copy of `gaussianavatar_tpu/config.py`.

Same dataclasses, flag names, defaults and `cfg_args.json` layout, so a
`cfg_args.json` written by either package loads in the other. The port
reads only the raster fields in `PORT_RASTER_FIELDS` (the tile size, the
footprint caps, and the training need table and adaptive footprint that
`--ragged 1 --auto_cascade 1` turn on, engine/need_table.py; the JAX
train CLIs and the port's `train` turn them on by default above 256
queries, `resolve_train_raster_defaults`); the rest steer TPU capacity
machinery (static-shape cascades, ragged chunk budgets, sampled retunes,
gather layouts) that the port's blend does not need. They, and
the few other fields in `PORT_IGNORED_FIELDS`, still parse and still
round-trip through `cfg_args.json`; `ignored_flags_note` names them all.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def smpl_canonical_pose() -> np.ndarray:
    """Canonical pose for SMPL: legs splayed +-30 deg (hip z rotations)."""
    leg_angle = 30.0
    cpose = np.zeros(72, dtype=np.float32)
    cpose[5] = leg_angle / 180.0 * math.pi
    cpose[8] = -leg_angle / 180.0 * math.pi
    return cpose


def smplx_canonical_pose() -> np.ndarray:
    """Canonical pose for SMPL-X (165-dim full pose)."""
    leg_angle = 30.0
    cpose = np.zeros(165, dtype=np.float32)
    cpose[5] = leg_angle / 180.0 * math.pi
    cpose[8] = -leg_angle / 180.0 * math.pi
    return cpose


@dataclass
class ModelParams:
    source_path: str = ""          # -s
    model_path: str = ""           # -m
    project_path: str = field(default_factory=os.getcwd)
    smpl_model_path: str = ""      # defaults to <project>/assets/smpl_files/smpl
    smplx_model_path: str = ""
    test_folder: str = ""          # defaults to <project>/assets/test_pose
    stage1_out_path: str = ""
    save_epoch: int = 30
    train_stage: int = 1
    dataset_type: str = "peeplesnapshot"
    smpl_gender: str = "neutral"
    smpl_type: str = "smpl"
    no_mask: int = 0
    fixed_inp: int = 0
    train_mode: int = 0
    cam_static: int = 1
    cache_frames: int = 1
    white_background: bool = True  # -w
    bullet_pose_list: List[int] = field(default_factory=lambda: [112, 217, 755])
    batch_size: int = 2
    query_posmap_size: int = 512
    inp_posmap_size: int = 128

    def __post_init__(self):
        if not self.smpl_model_path:
            self.smpl_model_path = os.path.join(self.project_path, "assets/smpl_files/smpl")
        if not self.smplx_model_path:
            self.smplx_model_path = os.path.join(self.project_path, "assets/smpl_files/smplx")
        if not self.test_folder:
            self.test_folder = os.path.join(self.project_path, "assets/test_pose")


@dataclass
class NetworkParams:
    c_pose: int = 64
    c_geom: int = 64
    hsize: int = 128
    nf: int = 32
    up_mode: str = "upconv"
    use_dropout: int = 0
    pos_encoding: int = 0
    num_emb_freqs: int = 6
    posemb_incl_input: int = 0
    geom_layer_type: str = "conv"
    gaussian_kernel_size: int = 5
    # ShapeDecoder matmuls and inter-layer activations in bf16; params and
    # BatchNorm statistics stay f32 (models/decoder.py)
    bf16_decoder: int = 1
    fused_decoder: int = 0


@dataclass
class OptimizationParams:
    epochs: int = 200
    lambda_dssim: float = 0.2
    lambda_scale: float = 3e-2
    lambda_lpips: float = 0.2
    lambda_aiap: float = 0.1
    lambda_pose: float = 10.0
    lambda_rgl: float = 1e1
    log_iter: int = 2000
    lpips_start_iter: int = 30
    pose_op_start_iter: int = 1800
    lr_net: float = 3e-3
    lr_geomfeat: float = 5e-4
    lr_pose: float = 5e-3
    steps_per_dispatch: int = 8
    sched_milestones: List[int] = field(default_factory=list)
    sched_unit: str = "iteration"
    use_aiap: bool = False

    def __post_init__(self):
        if not self.sched_milestones:
            self.sched_milestones = [self.epochs // 3, self.epochs * 2 // 3]


@dataclass
class RasterParams:
    """Rasterizer knobs. The port reads PORT_RASTER_FIELDS only."""
    tile_size: int = 32
    tile_capacity: int = 128
    max_tiles_per_gaussian: int = 9
    backend: str = "auto"
    tile_capacity_hi: int = 768
    heavy_fraction: float = 0.25
    train_tile_capacity_hi: int = 768
    train_heavy_fraction: float = 0.25
    sort_stable: int = 1
    render_sort_stable: int = 0
    # render-side gaussian footprint cap (0 = same as max_tiles_per_gaussian)
    render_max_tiles_per_gaussian: int = 4
    auto_cascade: int = 0
    gather_flat: int = 0
    gather_window: int = 0
    ragged: int = 0
    ragged_chunk: int = 128
    ragged_budget: int = 0
    ragged_margin: float = 1.5
    train_footprint_adapt: int = 1
    train_footprint_eps: float = 1e-3
    retune_sample: int = 6
    retune_drift_eps: float = 2e-2
    ragged_eval: int = 0
    blend_vec: int = 1


# The raster fields the port reads. Every other RasterParams field steers
# TPU machinery; `ignored_flags_note` names them once at startup.
PORT_RASTER_FIELDS = ("tile_size", "max_tiles_per_gaussian",
                      "render_max_tiles_per_gaussian", "ragged", "auto_cascade",
                      "ragged_margin", "train_footprint_adapt", "train_footprint_eps")

# The other fields the port parses (they round-trip through cfg_args.json)
# and does not act on, each with the reason.
PORT_IGNORED_FIELDS = {
    "cache_frames": "the port keeps every frame on the device as a uint8 bank",
    "train_mode": "read by neither package",
    "gaussian_kernel_size": "read by neither package",
}


def ignored_flags_note() -> str:
    """One line naming every flag the port accepts and does not act on."""
    ignored = [f.name for f in dataclasses.fields(RasterParams)
               if f.name not in PORT_RASTER_FIELDS]
    return ("gaussianavatar_torch ignores the TPU-only raster knobs "
            "(the blend walks every tile's whole range, or as far as the need table "
            "allows, sorts stably, probes every frame at a retune, and has one "
            "kernel): " + ", ".join(ignored) + "; and "
            + "; ".join(f"{k} ({why})" for k, why in PORT_IGNORED_FIELDS.items()))


def _add_group(parser: ArgumentParser, cls, name: str, shorthands: dict):
    group = parser.add_argument_group(name)
    for f in dataclasses.fields(cls):
        flag = "--" + f.name
        names = [flag] + ([shorthands[f.name]] if f.name in shorthands else [])
        if f.type in ("bool", bool):
            group.add_argument(*names, default=None, action="store_true")
        elif f.type in ("List[int]", List[int]):
            group.add_argument(*names, nargs="+", type=int, default=None)
        else:
            ftype = {"int": int, "float": float, "str": str}.get(f.type, None)
            if ftype is None:
                ftype = f.type if isinstance(f.type, type) else str
            # default None: fill at extract time so cfg_args merging can
            # detect "unset"
            group.add_argument(*names, default=None, type=ftype)


_SHORTHANDS = {"source_path": "-s", "model_path": "-m", "white_background": "-w"}


def build_parser(parser: Optional[ArgumentParser] = None) -> ArgumentParser:
    parser = parser or ArgumentParser()
    _add_group(parser, ModelParams, "Loading Parameters", _SHORTHANDS)
    _add_group(parser, NetworkParams, "Network Parameters", {})
    _add_group(parser, OptimizationParams, "Optimization Parameters", {})
    _add_group(parser, RasterParams, "Rasterizer Parameters", {})
    return parser


def _extract(cls, args: Namespace, overrides: Optional[dict] = None):
    kwargs = {}
    names = {f.name for f in dataclasses.fields(cls)}
    if overrides:
        kwargs.update({k: v for k, v in overrides.items() if k in names})
    for k, v in vars(args).items():
        if k in names and v is not None:
            kwargs[k] = v
    return cls(**kwargs)


@dataclass
class Config:
    model: ModelParams
    net: NetworkParams
    opt: OptimizationParams
    raster: RasterParams

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "model": dataclasses.asdict(self.model),
            "net": dataclasses.asdict(self.net),
            "opt": dataclasses.asdict(self.opt),
            "raster": dataclasses.asdict(self.raster),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)

    @staticmethod
    def load(path: str) -> "Config":
        with open(path) as f:
            payload = json.load(f)
        return Config(
            model=ModelParams(**payload["model"]),
            net=NetworkParams(**payload["net"]),
            opt=OptimizationParams(**payload["opt"]),
            raster=RasterParams(**payload.get("raster", {})),
        )


# the largest query posmap the JAX package's fixed capacity cascade was
# swept at; above it the JAX train CLIs and the port's `train` default to
# the need table
SWEPT_CASCADE_MAX_QUERY = 256


def resolve_train_raster_defaults(cfg: Config, args: Optional[Namespace] = None) -> List[str]:
    """The JAX train CLIs' defaults for the workload (gaussianavatar_tpu/
    config.py `resolve_train_raster_defaults`), applied to `cfg` -> the
    notes to print: above SWEPT_CASCADE_MAX_QUERY queries `ragged` and
    `auto_cascade` default to 1 (the need table and the adaptive
    footprint, engine/need_table.py) unless given on the command line
    (`--ragged 0` or `--auto_cascade 0` opts out). Called by the `train`
    and `train_multi` CLIs after `extract_config`."""
    notes = []
    explicit = lambda name: args is not None and getattr(args, name, None) is not None
    r, q = cfg.raster, cfg.model.query_posmap_size
    if q > SWEPT_CASCADE_MAX_QUERY:
        if not r.ragged and not explicit("ragged"):
            r.ragged = 1
            notes.append(f"raster defaults: query_posmap_size {q} > {SWEPT_CASCADE_MAX_QUERY} "
                         "-> ragged=1 (the per-frame need table of row caps. Opt out: "
                         "--ragged 0)")
        if not r.auto_cascade and not explicit("auto_cascade"):
            r.auto_cascade = 1
            notes.append("raster defaults: auto_cascade=1 (the caps and the footprint from "
                         "the scene's own saturation probe. Opt out: --auto_cascade 0)")
    return notes


def extract_config(args: Namespace, saved: Optional[Config] = None) -> Config:
    """Build a Config from parsed args; CLI flags override `saved` (the
    cfg_args written at train time), which overrides defaults."""
    ov = lambda c: dataclasses.asdict(c) if saved else None
    return Config(
        model=_extract(ModelParams, args, ov(saved.model) if saved else None),
        net=_extract(NetworkParams, args, ov(saved.net) if saved else None),
        opt=_extract(OptimizationParams, args, ov(saved.opt) if saved else None),
        raster=_extract(RasterParams, args, ov(saved.raster) if saved else None),
    )
