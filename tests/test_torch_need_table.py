"""Port parity, the training need table and adaptive footprint
(engine/need_table.py) against the JAX package's (`--ragged 1
--auto_cascade 1`, gaussianavatar_tpu/engine/loop.py):

1. the saturation probe (`probe_tile_depths`) and the candidate footprint's
   clip count (`footprint_drop`) on the same projected gaussians: the
   binned counts, the needed depths and the pair counts agree exactly
   (they are integers, and the blend's n_contrib is exact against the
   sequential JAX kernel, tests/test_torch_raster.py);
2. the probe of a whole network (`NeedTable.probe`) against the JAX loop's
   `make_counts_fn` on the same weights (bridge.state_dict_from_jax): the
   two sides pose the gaussians with float32 LBS summed in different
   orders, so a tile's needed depth may move where an ulp moves a rect or a
   depth key (tests/test_torch_slice.py); the bound is stated there;
3. the switch: the flags that turn the table on in the JAX loop, and the
   train CLIs' defaults (both `train` and `train_multi` resolve them as the
   JAX CLIs do, and train_multi's subjects start from JAX's keys);
4. the CLIs on the CPU with the table on (`train`, `train_multi`): their
   events, their probe counts, and the footprint decision the JAX rule
   takes on the logged clip fraction.
"""

import json
import math
from os.path import join
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.ops import rasterize_tile as jt
from gaussianavatar_tpu.ops.projection import ProjectedGaussians as JProj
from gaussianavatar_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig

from gaussianavatar_torch.engine import need_table
from gaussianavatar_torch.ops import rasterize_tile as tt
from gaussianavatar_torch.ops.rasterize import RasterizeConfig

from test_torch_raster import H, TS, W, to_torch_proj  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    from test_torch_raster import jax_project, make_scene

    means, scales, q, opac, colors, cams = make_scene(n=300, seed=4, opac_range=(0.05, 0.9),
                                                      spread=0.3)
    return opac, colors, jax_project(means, scales, q, cams)


@pytest.mark.parametrize("M", [4, 9, 16])
def test_probe_and_footprint_drop_match_jax(scene, M):
    opac, colors, jp = scene
    cap = 128
    jproj = JProj(*(jnp.asarray(x) for x in jp))
    jcfg = JRasterizeConfig(tile_size=TS, max_tiles_per_gaussian=M, backend="pallas_interpret",
                            sort_stable=True, blend_vec=0)
    j_counts, j_need = jax.jit(jt.probe_tile_depths, static_argnums=(3, 4, 5, 6))(
        jproj, jnp.asarray(colors), jnp.asarray(opac), H, W, jcfg, cap)
    t_counts, t_need = tt.probe_tile_depths(to_torch_proj(jp), torch.as_tensor(colors),
                                            torch.as_tensor(opac), H, W,
                                            RasterizeConfig(TS, M), cap)
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(t_need.numpy(), np.asarray(j_need))
    # the scene has tiles where the blend stops early and tiles it walks whole
    need, counts = t_need.numpy(), t_counts.numpy()
    assert (need < np.minimum(counts, cap)).any() and (need > 0).any()

    j_drop = jax.jit(jt.footprint_drop, static_argnums=(2, 3, 4, 5))(
        jproj, jnp.asarray(opac), H, W, TS, M)
    t_drop = tt.footprint_drop(to_torch_proj(jp), torch.as_tensor(opac), H, W, TS, M)
    assert [int(x) for x in t_drop] == [int(x) for x in j_drop]
    if M == 4:
        assert 0 < int(t_drop[0]) < int(t_drop[1])


def test_network_probe_matches_jax(monkeypatch):
    """NeedTable.probe (eval mode, the inference iteration, every frame in
    batches of B with the last wrapping) against the JAX `make_counts_fn`
    on the same weights, stage 1, 5 frames in batches of 2. Bound: the
    needed depth equals JAX's on at least 97% of the (frame, tile) cells
    and never moves by more than 4 ranks; the candidate footprint's
    clipped and total pairs within 0.5% of JAX's."""
    from gaussianavatar_tpu.engine.inference import make_counts_fn
    from gaussianavatar_tpu.engine.train_step import init_state
    from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
    from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
    from gaussianavatar_tpu.ops.camera import Camera as JCamera
    from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
    from gaussianavatar_tpu.utils.synthetic import synthetic_pose

    from gaussianavatar_torch import bridge
    from gaussianavatar_torch.config import Config, ModelParams, NetworkParams
    from gaussianavatar_torch.config import OptimizationParams, RasterParams
    from gaussianavatar_torch.engine.setup import AvatarBundle
    from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
    from gaussianavatar_torch.utils.synthetic import synthetic_body

    cap, F, B, Hs, Ws = 256, 5, 2, 64, 64
    monkeypatch.setattr(need_table, "PROBE_CAPACITY", cap)
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    args = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt, np.zeros(J * 3, np.float32),
            np.zeros(4, np.float32))
    ja = j_build_assets(jm, *args, query_res=48, pad_to=64)
    poses = np.stack([synthetic_pose(jm, t / F) for t in range(F)]).astype(np.float32)
    kw = dict(c_geom=8, inp_posmap_size=16, hsize=16)

    class TX0:
        def init(self, p):
            return None

    jnet = JAvatarNet(num_frames=F, pose_dim=J * 3, pose_init=poses, **kw)
    st = init_state(jnet, ja, TX0(), rng=jax.random.PRNGKey(5), batch_size=B)
    params = jax.tree.map(np.asarray, st.params)
    stats = jax.tree.map(np.asarray, st.batch_stats)

    K = np.array([[70.0, 0, Ws / 2], [0, 70.0, Hs / 2], [0, 0, 1]], np.float32)
    frames = []
    for i in range(F):
        cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                      np.array([0.04 * i, -0.8, 1.6], np.float32), K, Hs, Ws)
        frames.append({"pose_idx": np.int32(i),
                       "world_view_transform": np.asarray(cam.world_view_transform),
                       "full_proj_transform": np.asarray(cam.full_proj_transform),
                       "tan_fovx": np.float32(cam.tan_fovx), "tan_fovy": np.float32(cam.tan_fovy)})

    counts = make_counts_fn(SimpleNamespace(net=jnet, body_model=jm, assets=ja), Hs, Ws,
                            JRasterizeConfig(tile_size=16, max_tiles_per_gaussian=9,
                                             backend="xla", sort_stable=True),
                            probe_capacity=cap, cand_m=4)
    T = (Hs // 16) * (Ws // 16)
    j_need = np.zeros((F, T), np.int64)
    j_clip = np.zeros(2, np.int64)
    for i in range(0, F, B):
        idxs = [(i + j) % F for j in range(B)]
        feed = {k: jnp.asarray(np.stack([frames[n][k] for n in idxs])) for k in frames[0]}
        out = counts(st.params, st.batch_stats, feed)
        for j, n in enumerate(idxs):
            if n >= i:  # a frame keeps its first probe's row
                j_need[n] = np.asarray(out[1]).reshape(B, T)[j]
        j_clip += [int(out[2]), int(out[3])]

    tm, _ = synthetic_body()
    ta = build_avatar_assets(tm, *args, query_res=48, pad_to=64, device="cpu")
    tnet = AvatarNet(F, J * 3, device="cpu", **kw)
    tnet.load_state_dict(bridge.state_dict_from_jax(params, stats))
    tnet.train()
    cfg = Config(ModelParams(batch_size=B), NetworkParams(), OptimizationParams(),
                 RasterParams(ragged=1, auto_cascade=1))
    table = need_table.NeedTable(cfg, AvatarBundle(tm, ta, tnet, frames), frames,
                                 RasterizeConfig(16, 9), Hs, Ws)
    t_need, t_clip = (x.numpy() for x in table.probe())
    assert tnet.training  # the probe puts the network's mode back
    assert table.probes == -(-F // B)
    assert j_need.max() > 2 and (j_need < cap).any()
    d = np.abs(t_need - j_need)
    assert (d == 0).mean() >= 0.97 and d.max() <= 4, (d.max(), (d == 0).mean())
    assert j_clip[1] > 0
    np.testing.assert_allclose(t_clip, j_clip, rtol=5e-3)


@pytest.mark.parametrize("argv, on", [
    ([], False), (["--ragged", "1"], False), (["--auto_cascade", "1"], False),
    (["--ragged", "1", "--auto_cascade", "1"], True),
    (["--query_posmap_size", "128", "--ragged", "1", "--auto_cascade", "1"], True),
    (["--ragged", "0"], False), (["--query_posmap_size", "256"], False),
], ids=["q512", "ragged1", "cascade1", "both1", "q128_both1", "ragged0", "q256"])
def test_need_table_switch(argv, on):
    """The table runs where the JAX loop's does, `ragged` and `auto_cascade`
    both set: on the flags as given (`on`), and after both packages' train
    CLIs apply their defaults (`resolve_train_raster_defaults`: both on
    above 256 queries unless given), where the port's switch follows the
    JAX CLI's on every case."""
    from gaussianavatar_tpu import config as jconfig

    from gaussianavatar_torch import config as tconfig

    jargs = jconfig.build_parser().parse_args(argv)
    jcfg = jconfig.extract_config(jargs)
    targs = tconfig.build_parser().parse_args(argv)
    tcfg = tconfig.extract_config(targs)
    assert need_table.enabled(tcfg) == on
    # the JAX loop's own condition on the same flags, before its CLI defaults
    assert on == bool(jcfg.raster.ragged and jcfg.raster.auto_cascade)
    j_notes = jconfig.resolve_train_raster_defaults(jcfg, jargs)
    t_notes = tconfig.resolve_train_raster_defaults(tcfg, targs)
    assert need_table.enabled(tcfg) == bool(jcfg.raster.ragged and jcfg.raster.auto_cascade)
    assert (tcfg.raster.ragged, tcfg.raster.auto_cascade) == \
        (jcfg.raster.ragged, jcfg.raster.auto_cascade)
    assert len(t_notes) == len([n for n in j_notes if n.startswith("raster defaults")])


@pytest.mark.parametrize("argv, table, init, notes", [
    ([], True, "flax", 2), (["--ragged", "0"], False, "flax", 1),
    (["--query_posmap_size", "256"], False, "flax", 0), (["--init", "torch"], True, "torch", 2),
], ids=["defaults", "ragged0", "q256", "init_torch"])
def test_train_cli_defaults(argv, table, init, notes):
    """The train CLI's defaults are the JAX CLI's: flax's initial network,
    and above 256 queries the need table, unless a flag says otherwise
    (`--ragged 0` leaves auto_cascade's default, as in JAX); each default
    it applies is printed as a note."""
    from gaussianavatar_torch import train

    args, cfg = train.parse_args(["-s", "/data", "-m", "/out"] + argv)
    assert need_table.enabled(cfg) == table and args.init == init
    assert len(args.raster_notes) == notes


@pytest.mark.parametrize("argv, table, init", [
    ([], True, "flax"), (["--init", "flax", "--ragged", "1", "--auto_cascade", "1"], True,
                         "flax"),
    (["--init", "torch", "--ragged", "0", "--auto_cascade", "0"], False, "torch"),
], ids=["defaults", "asked", "opted_out"])
def test_train_multi_cli_defaults(argv, table, init):
    """train_multi takes the JAX CLI's defaults, as train does: flax's
    initial networks (subject s draws PRNGKey(s)) and, at 512 queries, the
    need table for every subject; `--init torch --ragged 0 --auto_cascade 0`
    gives the whole-range blend from torch's initialisation."""
    from gaussianavatar_torch import train_multi

    args, cfgs = train_multi.parse_args(["--sources", "/a", "/b", "-m", "/out"] + argv)
    assert args.init == init and len(cfgs) == 2
    assert [need_table.enabled(c) for c in cfgs] == [table, table]
    assert [c.model.model_path for c in cfgs] == ["/out/a", "/out/b"]


@pytest.mark.parametrize("argv", [[], ["--ragged", "0"], ["--query_posmap_size", "256"]],
                         ids=["defaults", "ragged0", "q256"])
def test_train_multi_cfgs_match_jax_cli(argv):
    """Every subject's cfg from `train_multi.parse_args` equals the JAX
    root train_multi.py's (its parser, `extract_config` and
    `resolve_train_raster_defaults` for each subject, then the subject's
    paths; train_multi.py:70-79), and one note is printed for each default
    the JAX CLI applies."""
    from argparse import ArgumentParser
    import dataclasses

    from gaussianavatar_tpu import config as jconfig

    from gaussianavatar_torch import train_multi

    cli = ["--sources", "/d/a", "/e/a", "/f/b", "-m", "/out"] + argv
    args, cfgs = train_multi.parse_args(cli)
    jp = ArgumentParser()
    jconfig.build_parser(jp)
    jp.add_argument("--sources", nargs="+", required=True)
    jargs = jp.parse_args(cli)
    jcfgs, j_notes = [], None
    for src, name in zip(jargs.sources, train_multi.subject_names(jargs.sources)):
        jcfg = jconfig.extract_config(jargs)
        notes = jconfig.resolve_train_raster_defaults(jcfg, jargs)
        j_notes = notes if j_notes is None else j_notes
        jcfg.model.source_path = src
        jcfg.model.model_path = join("/out", name)
        jcfgs.append(jcfg)
    assert [dataclasses.asdict(c) for c in cfgs] == [dataclasses.asdict(c) for c in jcfgs]
    assert [c.model.model_path for c in cfgs] == ["/out/a", "/out/a_1", "/out/b"]
    # one note for each default applied, as the JAX CLI prints (the port's
    # wording names its own kernels)
    assert len(args.raster_notes) == len([n for n in j_notes if n.startswith("raster defaults")])
    assert need_table.enabled(cfgs[0]) == (argv == [])


def test_train_multi_subjects_start_from_jax_keys(tmp_path):
    """On the defaults, `build_subjects` gives subject s the JAX multi-subject
    loop's network, `init_state(..., rng=PRNGKey(s))`
    (gaussianavatar_tpu/engine/multi_loop.py:159), leaf for leaf within
    4.4e-6 (the inverse error function's ulps, tests/test_torch_init.py);
    the two subjects' networks differ."""
    from argparse import ArgumentParser

    from gaussianavatar_tpu import config as jconfig
    from gaussianavatar_tpu.engine.setup import setup_avatar as j_setup_avatar
    from gaussianavatar_tpu.engine.train_step import init_state

    from gaussianavatar_torch import bridge, train_multi
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine.multi_loop import build_subjects

    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_train=4, n_test=1, image_size=48, device="cpu")
    small = ["--dataset_type", "synthetic", "--query_posmap_size", "32",
             "--inp_posmap_size", "16", "--c_geom", "8", "--hsize", "16"]
    args, cfgs = train_multi.parse_args(["--sources", data, data, "-m", str(tmp_path / "o"),
                                         "--device", "cpu", *small])
    subjects, _, _ = build_subjects(cfgs, "cpu")
    jp = ArgumentParser()
    jconfig.build_parser(jp)
    jcfg = jconfig.extract_config(jp.parse_args(["-s", data, *small]))
    jb = j_setup_avatar(jcfg, train=True)

    class _TX0:
        def init(self, p):
            return None

    port = [s.bundle.net.state_dict() for s in subjects]
    for s in range(2):
        st = init_state(jb.net, jb.assets, _TX0(), rng=jax.random.PRNGKey(s),
                        batch_size=jcfg.model.batch_size)
        jax_sd = bridge.state_dict_from_jax(jax.tree.map(np.asarray, st.params),
                                            jax.tree.map(np.asarray, st.batch_stats))
        assert port[s].keys() == jax_sd.keys()
        for k, j in jax_sd.items():
            np.testing.assert_allclose(port[s][k].numpy(), j.numpy(), rtol=0, atol=4.4e-6,
                                       err_msg=f"subject {s}: {k}")
    assert not torch.equal(port[0]["geo_feature"], port[1]["geo_feature"])


def test_footprint_rule():
    """The JAX loop's hysteresis, case by case (M 9 <-> 4, eps 1e-3)."""
    rule = lambda frac, cur: need_table.footprint_for(frac, cur, 9, 4, 1e-3)
    assert rule(None, 9) == 9 and rule(0.0, 9) == 4 and rule(1e-3, 9) == 4
    assert rule(1.1e-3, 9) == 9 and rule(2.9e-3, 4) == 4 and rule(3e-3, 4) == 9
    assert rule(1.0, 9) == 9 and rule(0.0, 4) == 4


def test_train_cli_with_need_table(tmp_path, capsys):
    """Tiny stage-1 run, --ragged 1 --auto_cascade 1: the table is built before epoch 1 and rebuilt after it and
    at each save epoch, the probes are logged, the footprint follows the
    rule on the logged clip fraction, and the loss falls."""
    from gaussianavatar_torch import train
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    write_synthetic_dataset(data, n_train=4, n_test=2, image_size=48, device="cpu")
    train.main(["-s", data, "-m", out, "--train_stage", "1", "--device", "cpu",
                "--max_steps", "12", "--save_epochs", "5", "--save_epoch", "3",
                "--ragged", "1", "--auto_cascade", "1",
                "--dataset_type", "synthetic", "--query_posmap_size", "32",
                "--inp_posmap_size", "16", "--c_geom", "8", "--hsize", "16",
                "--bf16_decoder", "0", "--tile_size", "16"])
    printed = capsys.readouterr().out
    assert "ragged need table: 4 frames" in printed
    records = [json.loads(line) for line in open(join(out, "metrics.jsonl"))]
    events = [(r["event"], r["value"]) for r in records if "event" in r]
    names = [e for e, _ in events]
    # 6 epochs of 2 steps: the build, then retunes after epochs 1 and 3 (6 is the end)
    assert names.count("ragged_need_bank") == 1 and names.count("ragged_drift") == 2
    assert dict(events)["need_table_probes"] == 3 * 2  # 3 probes of 2 batches
    bank = dict(events)["ragged_need_bank"]
    frac = float(bank.split("fp_clip ")[1])
    want_m = need_table.footprint_for(frac, 9, 9, 4, 1e-3)
    adapts = [v for e, v in events if e == "footprint_adapt"]
    assert (want_m == 4) == bool(adapts) and (not adapts or adapts[0].startswith("M 4"))
    steps = {r["step"]: r for r in records if "step" in r}
    assert steps[max(steps)]["total"] < steps[min(steps)]["total"]
    assert all(math.isfinite(r["raster_overflow"]) for r in steps.values())


def test_train_multi_with_need_tables(tmp_path):
    """Two subjects, --ragged 1 --auto_cascade 1: each subject's log holds
    its initialisation (JAX's PRNGKey(s)), its own table's build, its own
    reading at the epoch-1 retune and the run's probes (both subjects'),
    and the subjects share one footprint, decided by the worst clip
    fraction."""
    from gaussianavatar_torch import train_multi
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    srcs = []
    for name, n in (("a", 4), ("b", 6)):
        d = str(tmp_path / name)
        write_synthetic_dataset(d, n_train=n, n_test=1, image_size=48, device="cpu")
        srcs.append(d)
    out = str(tmp_path / "out")
    train_multi.main(["--sources", *srcs, "-m", out, "--train_stage", "1", "--device", "cpu",
                      "--max_steps", "4", "--save_epochs", "5", "--ragged", "1",
                      "--auto_cascade", "1", "--dataset_type", "synthetic",
                      "--query_posmap_size", "32", "--inp_posmap_size", "16", "--c_geom", "8",
                      "--hsize", "16", "--bf16_decoder", "0", "--tile_size", "16"])
    fracs, adapts = [], []
    for s, (name, n) in enumerate((("a", 4), ("b", 6))):
        records = [json.loads(line) for line in open(join(out, name, "metrics.jsonl"))]
        events = [(r["event"], r["value"]) for r in records if "event" in r]
        assert dict(events)["init"] == f"flax PRNGKey({s})"
        retunes = [v for e, v in events if e == "ragged_retune"]
        assert len(retunes) == 1 and sorted(retunes[0]) == ["clip_frac_m4", "drift"]
        assert 0.0 <= retunes[0]["clip_frac_m4"] <= 1.0 and 0.0 <= retunes[0]["drift"] <= 1.0
        bank = dict(events)["ragged_need_bank"]
        assert bank.startswith(f"frames {n} ")
        fracs.append(float(bank.split("fp_clip ")[1]))
        adapts.append([v for e, v in events if e == "footprint_adapt"])
        # 2 epochs of 2 steps: the build and the epoch-1 retune, 2 + 3 batches each
        assert dict(events)["need_table_probes"] == 2 * (2 + 3)
        assert [e for e, _ in events].count("ragged_drift") == 1
    assert adapts[0] == adapts[1]
    want_m = need_table.footprint_for(max(fracs), 9, 9, 4, 1e-3)
    assert (want_m == 4) == bool(adapts[0])
