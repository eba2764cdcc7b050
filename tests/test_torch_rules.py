"""Rules of the port: it imports nothing of JAX, its entry points run on the
card unless asked for the CPU and never fall back on their own, its config
and checkpoint files interoperate, and its kernels (H-fwd, H-bwd and the
fused decoder's H-dstat, H-dfwd, H-dbwd) build, count their launches,
refuse what they do not take and match their plain versions on the card
(those tests skip without CUDA)."""

import ast
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from os.path import join

import pytest
import torch

from gaussianavatar_torch import config as tconfig
from gaussianavatar_torch.engine import checkpoint as tckpt
from gaussianavatar_torch.ops import rasterize_tile as tt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = join(REPO, "gaussianavatar_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gaussianavatar_tpu")


def _port_files():
    files = [join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [join(root, n) for n in names if n.endswith(".py")]
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_port_modules_load_without_jax():
    mods = []
    for root, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py") and n != "__init__.py":
                rel = os.path.relpath(join(root, n[:-3]), REPO)
                mods.append(rel.replace(os.sep, "."))
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_kernel_call_raises_instead_of_falling_back(monkeypatch):
    """A non-CPU tensor goes to the kernel: if it cannot be built or loaded,
    the call raises and the plain version is never taken."""
    from gaussianavatar_torch.utils import cuda_build

    def broken_loader(name):
        raise RuntimeError(f"cannot build {name}")

    def plain_must_not_run(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(cuda_build, "load_library", broken_loader)
    monkeypatch.setattr(tt, "blend_tiles_plain", plain_must_not_run)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    with pytest.raises(RuntimeError, match="cannot build blend_fwd"):
        tt.blend_tiles(meta((8, 16), torch.float32), meta((8,), torch.int32),
                       meta((5,), torch.int32), 2, 16, 4)


def test_backward_kernel_call_raises_instead_of_falling_back(monkeypatch):
    """As above, for H-bwd."""
    from gaussianavatar_torch.utils import cuda_build

    def broken_loader(name):
        raise RuntimeError(f"cannot build {name}")

    def plain_must_not_run(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(cuda_build, "load_library", broken_loader)
    monkeypatch.setattr(tt, "blend_tiles_bwd_plain", plain_must_not_run)
    meta = lambda shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
    with pytest.raises(RuntimeError, match="cannot build blend_bwd"):
        tt.blend_tiles_bwd(meta((8, 16)), meta((8,), torch.int32), meta((5,), torch.int32),
                           2, 16, 4, meta((4, 256)), meta((4, 256), torch.int32),
                           meta((4, 3, 256)), meta((4, 256)))


@pytest.mark.parametrize("kernel", ["decoder_stats", "decoder_stage_fwd", "decoder_stage_bwd"])
def test_decoder_kernel_call_raises_instead_of_falling_back(monkeypatch, kernel):
    """As above, for the fused decoder's three kernels."""
    from gaussianavatar_torch.ops import decoder_stage as ds
    from gaussianavatar_torch.utils import cuda_build

    def broken_loader(name):
        raise RuntimeError(f"cannot build {name}")

    def plain_must_not_run(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(cuda_build, "load_library", broken_loader)
    for name in ("column_stats_plain", "stage_fwd_plain", "stage_bwd_plain"):
        monkeypatch.setattr(ds, name, plain_must_not_run)
    meta = lambda *shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt, device="meta")
    call = {"decoder_stats": lambda: ds.column_stats(meta(64, 128)),
            "decoder_stage_fwd": lambda: ds.stage_fwd(meta(64, 128), meta(128, 128),
                                                      meta(128), "softplus"),
            "decoder_stage_bwd": lambda: ds.stage_bwd(meta(64, 128), meta(64, 128), "softplus")}
    with pytest.raises(RuntimeError, match=f"cannot build {kernel}"):
        call[kernel]()


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    import inspect

    from gaussianavatar_torch import (
        eval as eval_cli, export_avatar_ply, export_stage_1, gen_pose_map_cano,
        gen_pose_map_frames, render_novel_pose, render_novel_view, render_pred_smpl, train,
        train_multi,
    )
    from gaussianavatar_torch.engine import inference, loop, multi_loop

    assert inspect.signature(inference.load_trained).parameters["device"].default == "cuda"
    assert inspect.signature(loop.train).parameters["device"].default == "cuda"
    assert inspect.signature(multi_loop.train_multi).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.Config(tconfig.ModelParams(model_path=str(tmp_path)), tconfig.NetworkParams(),
                         tconfig.OptimizationParams(), tconfig.RasterParams())
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        inference.load_trained(cfg)
    for cli in (render_novel_pose, eval_cli, render_novel_view):
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            cli.main(["-m", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train.main(["-s", str(tmp_path), "-m", str(tmp_path / "out")])
    # data-parallel and multi-subject runs too, before any rank starts
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train.main(["-s", str(tmp_path), "-m", str(tmp_path / "out"), "--dp", "2",
                    "--batch_size", "2"])
    for dp in ("1", "2"):
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            train_multi.main(["--sources", str(tmp_path), str(tmp_path), "-m",
                              str(tmp_path / "multi"), "--dp", dp, "--batch_size", "2"])
    # the preprocessing, overlay and export entry points too (sample_romp2gsavatar
    # and convert_lpips_weights convert files on the host and take no device)
    for argv in ([export_stage_1, ["-m", str(tmp_path), "-s", str(tmp_path)]],
                 [gen_pose_map_frames, ["--source_path", str(tmp_path), "--synthetic"]],
                 [gen_pose_map_cano, ["--source_path", str(tmp_path), "--synthetic"]],
                 [render_pred_smpl, ["--source_path", str(tmp_path), "--synthetic"]],
                 [export_avatar_ply, ["-m", str(tmp_path)]]):
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            argv[0].main(argv[1])


def test_dp_backend_is_chosen_by_the_sharing_rule_alone(tmp_path, monkeypatch):
    """NCCL when every rank has a card of its own, gloo when ranks share a
    card or run on the CPU; a failed NCCL start fails the run and is never
    retried on gloo."""
    from gaussianavatar_torch.parallel import mesh

    assert mesh.backend_for("cuda", 2, 2) == mesh.backend_for("cuda", 4, 8) == "nccl"
    assert mesh.backend_for("cuda", 2, 1) == mesh.backend_for("cuda", 4, 2) == "gloo"
    assert mesh.backend_for("cpu", 2, 8) == "gloo"
    assert [mesh.rank_device("cuda", r, 1) for r in range(2)] == ["cuda:0", "cuda:0"]
    assert [mesh.rank_device("cuda", r, 4) for r in range(4)] == [f"cuda:{r}" for r in range(4)]

    tried = []

    def init(backend, **kw):
        tried.append(backend)
        raise RuntimeError(f"{backend} failed to start")

    monkeypatch.setattr(mesh.dist, "init_process_group", init)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    with pytest.raises(RuntimeError, match="nccl failed to start"):
        mesh.init_group(0, 2, "cuda", str(tmp_path / "rendezvous"))
    assert tried == ["nccl"] and mesh.group() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="gloo failed to start"):
        mesh.init_group(0, 2, "cuda", str(tmp_path / "rendezvous"))
    assert tried == ["nccl", "gloo"] and mesh.group() is None


def _rank_fails(path):
    from gaussianavatar_torch.parallel import mesh

    if mesh.group().rank == 1:
        raise RuntimeError("rank 1 gave up")
    import time

    time.sleep(60)   # rank 0 waits on; the failure must stop it


def _rank_hangs(path):
    import time

    time.sleep(600)


def test_dp_ranks_fail_and_time_out_together(tmp_path):
    """A rank that fails fails the whole run (the others are stopped), and
    a run that outlasts its limit is killed and raises."""
    import time

    from gaussianavatar_torch.parallel import mesh

    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 gave up"):
        mesh.spawn_ranks(_rank_fails, 2, "cpu", (str(tmp_path),), timeout_s=120)
    with pytest.raises(TimeoutError, match="did not finish within 8 s"):
        mesh.spawn_ranks(_rank_hangs, 2, "cpu", (str(tmp_path),), timeout_s=8)
    assert time.monotonic() - t0 < 60


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, join(REPO, "chip_smoke.py")), (alone, alone / "chip_smoke.py")):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_cfg_args_interoperate(tmp_path):
    from gaussianavatar_tpu import config as jconfig

    jp = jconfig.build_parser()
    jcfg = jconfig.extract_config(jp.parse_args(["-s", "/data", "--tile_size", "16",
                                                 "--bf16_decoder", "0"]))
    jcfg.save(str(tmp_path / "jax.json"))
    tcfg = tconfig.Config.load(str(tmp_path / "jax.json"))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tcfg.save(str(tmp_path / "torch.json"))
    assert json.load(open(tmp_path / "torch.json")) == json.load(open(tmp_path / "jax.json"))
    assert dataclasses.asdict(jconfig.Config.load(str(tmp_path / "torch.json"))) \
        == dataclasses.asdict(jcfg)
    # CLI flags override cfg_args, as in the JAX package
    targs = tconfig.build_parser().parse_args(["--render_max_tiles_per_gaussian", "9"])
    merged = tconfig.extract_config(targs, tcfg)
    assert merged.raster.render_max_tiles_per_gaussian == 9 and merged.raster.tile_size == 16
    note = tconfig.ignored_flags_note()
    assert "ragged_budget" in note and "auto_cascade" in note and "tile_size" not in note


def test_startup_note_names_every_flag_the_port_ignores():
    """The startup note names each config field the port's code never reads
    (as an attribute or a quoted name, outside config.py), and no field it
    reads: the raster knobs outside PORT_RASTER_FIELDS, cache_frames and the
    fields neither package reads. fused_decoder and steps_per_dispatch,
    which the port acts on, are not among them."""
    src = "".join(open(f).read() for f in _port_files()
                  if f.startswith(PKG) and not f.endswith("config.py"))
    note = tconfig.ignored_flags_note()
    named = lambda name: re.search(rf"\b{name}\b", note) is not None
    for cls in (tconfig.ModelParams, tconfig.NetworkParams, tconfig.OptimizationParams):
        for f in dataclasses.fields(cls):
            read = re.search(rf'\.{f.name}\b|"{f.name}"', src) is not None
            assert named(f.name) != read, f.name
    for f in dataclasses.fields(tconfig.RasterParams):
        assert named(f.name) == (f.name not in tconfig.PORT_RASTER_FIELDS), f.name
    assert named("cache_frames")
    assert not named("fused_decoder") and not named("steps_per_dispatch")


def test_checkpoint_roundtrip(tmp_path):
    from gaussianavatar_torch.models.avatar import AvatarNet

    g = torch.Generator().manual_seed(0)
    net = AvatarNet(2, 15, c_geom=4, inp_posmap_size=8, hsize=8, generator=g, device="cpu")
    tckpt.save_checkpoint(str(tmp_path), 3, net)
    os.makedirs(join(tmp_path, "net", "iteration_7"))  # a JAX-only epoch: no net_torch.pt
    assert tckpt.latest_epoch(str(tmp_path)) == 3
    other = AvatarNet(2, 15, c_geom=4, inp_posmap_size=8, hsize=8, device="cpu")
    tckpt.load_checkpoint(str(tmp_path), 3, other)
    for (k, a), (_, b) in zip(net.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(FileNotFoundError, match="convert_jax_checkpoint_torch"):
        tckpt.load_checkpoint(str(tmp_path), 7, other)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (H-fwd has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_blend_kernel_matches_plain_on_card(cuda_device):
    from gaussianavatar_torch.ops.projection import ProjectedGaussians

    g = torch.Generator().manual_seed(1)
    B, N, H, W, ts = 2, 3000, 96, 128, 16
    u = lambda *s: torch.rand(s, generator=g)
    sig = 1.0 + 3.0 * u(B, N)
    projs = ProjectedGaussians(
        means2d=torch.stack([u(B, N) * W, u(B, N) * H], -1),
        depths=0.5 + u(B, N),
        conics=torch.stack([1 / sig**2, torch.zeros(B, N), 1 / sig**2], -1),
        radii=torch.ceil(3 * sig),
    )
    projs = ProjectedGaussians(*(x.to(cuda_device) for x in projs))
    ctx = tt._bin_gaussians(projs, u(B, N, 3).to(cuda_device), (0.4 + 0.6 * u(B, N)).to(cuda_device),
                            H, W, ts, 2, 2)
    txn = W // ts
    args = (ctx.packed, ctx.sorted_vals, ctx.offsets, txn, ts, txn * (H // ts))
    caps = (u(ctx.full_counts.shape[0]) * 1.2 * ctx.full_counts.cpu()).int().to(cuda_device)
    for c in (None, caps):
        ck, tk, nk, dk = tt.blend_tiles(*args, caps=c)
        cp, tp, np_, dp = tt.blend_tiles_plain(*args, caps=c)
        torch.testing.assert_close(ck, cp, atol=2e-5, rtol=0)
        torch.testing.assert_close(tk, tp, atol=1e-6, rtol=0)
        assert torch.equal(nk, np_) and torch.equal(dk, dp)


def _random_blend_inputs(device, opaque):
    """A binned random scene on `device`, H-fwd's outputs on it, a random
    cotangent and random per-tile caps."""
    from gaussianavatar_torch.ops.projection import ProjectedGaussians

    g = torch.Generator().manual_seed(2)
    B, N, H, W, ts = 2, 3000, 96, 128, 16
    u = lambda *s: torch.rand(s, generator=g)
    sig = 1.0 + 3.0 * u(B, N)
    projs = ProjectedGaussians(
        means2d=torch.stack([u(B, N) * W, u(B, N) * H], -1),
        depths=0.5 + u(B, N),
        conics=torch.stack([1 / sig**2, torch.zeros(B, N), 1 / sig**2], -1),
        radii=torch.ceil(3 * sig),
    )
    projs = ProjectedGaussians(*(x.to(device) for x in projs))
    opac = torch.ones(B, N) if opaque else 0.4 + 0.6 * u(B, N)
    ctx = tt._bin_gaussians(projs, u(B, N, 3).to(device), opac.to(device), H, W, ts, 2, 2)
    txn = W // ts
    args = (ctx.packed, ctx.sorted_vals, ctx.offsets, txn, ts, txn * (H // ts))
    G = ctx.full_counts.shape[0]
    caps = (u(G) * 1.2 * ctx.full_counts.cpu()).int().to(device)
    cot = (u(G, 3, ts * ts).to(device) - 0.5, u(G, ts * ts).to(device) - 0.5)
    return args, caps, cot


@pytest.mark.gpu
@pytest.mark.parametrize("opaque", [False, True], ids=["mixed", "opaque"])
def test_blend_bwd_kernel_matches_plain_on_card(cuda_device, opaque):
    """H-bwd against its plain version, uncapped and capped: per pair and
    channel within 1e-5 of the channel's largest |gradient| (sums over a
    tile's pixels in another order), and bit-identical across two runs."""
    args, caps, (g_color, g_T) = _random_blend_inputs(cuda_device, opaque)
    for c in (None, caps):
        _, T, ncon, _ = tt.blend_tiles(*args, caps=c)
        k1 = tt.blend_tiles_bwd(*args, T, ncon, g_color, g_T, caps=c)
        k2 = tt.blend_tiles_bwd(*args, T, ncon, g_color, g_T, caps=c)
        p = tt.blend_tiles_bwd_plain(*args, T, ncon, g_color, g_T, caps=c)
        assert torch.equal(k1, k2)
        assert bool(torch.isfinite(k1).all())
        scale = p.abs().amax(0)
        assert bool((scale > 0).all())
        assert bool(((k1 - p).abs().amax(0) <= 1e-5 * scale).all()), ((k1 - p).abs().amax(0), scale)


def _deep_tile_inputs(device, ts, opaque):
    """Two views of 4 x 4 tiles of ts px: 2000 gaussians per view over the
    first 2.5 tile columns (the last column stays empty), and on tile (1, 1)
    of view 0 a cluster of 1500 faint ones (opacity 0.01-0.04) that makes it
    ~1,900 rows deep among tiles of ~300; opaque: opacity 1 outside the
    cluster. Returns the blend's arguments, random caps (every third 0), a
    random cotangent and the per-tile counts."""
    from gaussianavatar_torch.ops.projection import ProjectedGaussians

    g = torch.Generator().manual_seed(3)
    B, H, W, n, n_deep = 2, 4 * ts, 4 * ts, 2000, 1500
    u = lambda *s: torch.rand(s, generator=g)
    mx = torch.cat([u(B, n) * 2.5 * ts, ts + 4 + u(B, n_deep) * (ts - 8)], 1)
    my = torch.cat([u(B, n) * H, ts + 4 + u(B, n_deep) * (ts - 8)], 1)
    sig = torch.cat([1.0 + 3.0 * u(B, n), 1.0 + 2.0 * u(B, n_deep)], 1)
    deep_op = torch.where(torch.arange(B)[:, None] == 0, 0.01 + 0.03 * u(B, n_deep),
                          torch.zeros(B, n_deep))
    op = torch.cat([torch.ones(B, n) if opaque else 0.3 + 0.7 * u(B, n), deep_op], 1)
    projs = ProjectedGaussians(
        means2d=torch.stack([mx, my], -1), depths=0.5 + u(B, n + n_deep),
        conics=torch.stack([1 / sig**2, torch.zeros_like(sig), 1 / sig**2], -1),
        radii=torch.ceil(3 * sig))
    projs = ProjectedGaussians(*(x.to(device) for x in projs))
    ctx = tt._bin_gaussians(projs, u(B, n + n_deep, 3).to(device), op.to(device), H, W, ts, 2, 2)
    txn = W // ts
    args = (ctx.packed, ctx.sorted_vals, ctx.offsets, txn, ts, txn * (H // ts))
    G = ctx.full_counts.shape[0]
    caps = (u(G) * 1.2 * ctx.full_counts.cpu()).int()
    caps[::3] = 0
    cot = (u(G, 3, ts * ts).to(device) - 0.5, u(G, ts * ts).to(device) - 0.5)
    return args, caps.to(device), cot, ctx.full_counts


@pytest.mark.gpu
@pytest.mark.parametrize("ts,opaque", [(32, False), (32, True), (24, False)],
                         ids=["ts32-mixed", "ts32-opaque", "ts24-mixed"])
def test_blend_kernels_match_plain_deep_tile_on_card(cuda_device, ts, opaque):
    """Both kernels at the canonical 32 px tile (and at 24, whose 12 x 12
    quadrants fill no whole warp) on a scene made for their work split and
    block order: one tile deeper than many 64-row H-fwd batches and 32-row
    H-bwd batches, a multiple of neither, among shallow ones; empty
    tiles; caps, some of them 0; opaque: opacity 1, so the 0.99 clamp
    bites. H-fwd: colour 2e-5, T 1e-6, n_contrib and done exact. H-bwd,
    on H-fwd's outputs: per pair and channel within 1e-5 of the channel's
    largest |gradient|, and two runs bit-identical."""
    args, caps, (g_color, g_T), counts = _deep_tile_inputs(cuda_device, ts, opaque)
    deepest = int(counts.max())
    assert deepest > 6 * 256 and deepest % 32 and int((counts == 0).sum()) > 0
    assert bool((caps == 0).any())
    for c in (None, caps):
        ck, tk, nk, dk = tt.blend_tiles(*args, caps=c)
        cp, tp, np_, dp = tt.blend_tiles_plain(*args, caps=c)
        torch.testing.assert_close(ck, cp, atol=2e-5, rtol=0)
        torch.testing.assert_close(tk, tp, atol=1e-6, rtol=0)
        assert torch.equal(nk, np_) and torch.equal(dk, dp)
        if c is None:  # the deep tile's walk goes past 24 H-fwd batches
            assert int(nk.max()) > 6 * 256
        k1 = tt.blend_tiles_bwd(*args, tk, nk, g_color, g_T, caps=c)
        k2 = tt.blend_tiles_bwd(*args, tk, nk, g_color, g_T, caps=c)
        p = tt.blend_tiles_bwd_plain(*args, tk, nk, g_color, g_T, caps=c)
        assert torch.equal(k1, k2)
        assert bool(torch.isfinite(k1).all())
        scale = p.abs().amax(0)
        assert bool((scale > 0).all())
        assert bool(((k1 - p).abs().amax(0) <= 1e-5 * scale).all()), ((k1 - p).abs().amax(0), scale)


@pytest.mark.gpu
def test_blend_bwd_kernel_rules_on_card(cuda_device):
    """H-bwd builds, counts one launch per call, and refuses CPU tensors,
    wrong shapes and wrong types instead of running."""
    from gaussianavatar_torch.utils import cuda_build

    assert os.path.exists(cuda_build.build_all(["blend_bwd"])["blend_bwd"].path)
    args, _, (g_color, g_T) = _random_blend_inputs(cuda_device, False)
    _, T, ncon, _ = tt.blend_tiles(*args)
    before = cuda_build.LAUNCHES["blend_bwd"]
    tt.blend_tiles_bwd(*args, T, ncon, g_color, g_T)
    assert cuda_build.LAUNCHES["blend_bwd"] == before + 1
    bad = {"cpu": (T.cpu(), ncon, g_color, g_T), "shape": (T, ncon, g_color[:, :2], g_T),
           "dtype": (T, ncon.float(), g_color, g_T)}
    for name, rest in bad.items():
        with pytest.raises(ValueError):
            tt.blend_tiles_bwd(*args, *rest)
    # the kernels copy packed rows in 16-byte chunks
    packed = args[0]
    shifted = torch.empty(packed.numel() + 1, device=cuda_device)[1:].view_as(packed)
    shifted.copy_(packed)
    with pytest.raises(ValueError, match="aligned"):
        tt.blend_tiles_bwd(shifted, *args[1:], T, ncon, g_color, g_T)
    with pytest.raises(ValueError, match="aligned"):
        tt.blend_tiles(shifted, *args[1:])
    assert cuda_build.LAUNCHES["blend_bwd"] == before + 1


def _ulp(t):
    """One ulp of each element of t (bfloat16 or float32), at least the
    smallest normal number's."""
    a = t.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - (7 if t.dtype == torch.bfloat16 else 23))


def _decoder_stage_inputs(device, C, x_dtype, cdt, R, H=128):
    """A stage's input (positive, as an activation, except the float32
    first stage's), folded weights, bias and an output cotangent."""
    g = torch.Generator().manual_seed(C + R + (0 if H == 128 else 1000 * H))
    x = torch.randn(R, C, generator=g)
    if x_dtype == torch.bfloat16:
        x = torch.nn.functional.softplus(x)
    Wp = torch.randn(C, H, generator=g) / C ** 0.5
    bp = 0.1 * torch.randn(H, generator=g)
    cot = 1e-2 * torch.randn(R, H, generator=g)
    return (x.to(x_dtype).to(device), Wp.to(cdt).to(device), bp.to(cdt).to(device),
            cot.to(cdt).to(device))


# the other widths the JAX decoder takes (--hsize H: inputs 66, H, 66 + H;
# an odd --c_geom: 65 and 193 at H = 128; a 600-wide input, whose H-dstat
# keeps one x^T buffer and H-dfwd one stage): (C, x dtype, compute dtype, H)
_F32, _BF16 = torch.float32, torch.bfloat16
DECODER_WIDTHS = [(66, _F32, _BF16, 96), (96, _BF16, _BF16, 96), (162, _BF16, _BF16, 96),
                  (64, _BF16, _BF16, 64), (256, _BF16, _BF16, 256), (322, _BF16, _BF16, 256),
                  (65, _F32, _BF16, 128), (193, _BF16, _BF16, 128), (66, _F32, _F32, 96),
                  (322, _F32, _F32, 256), (97, _BF16, _BF16, 97), (600, _BF16, _BF16, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["softplus", "relu"])
@pytest.mark.parametrize("C,x_dtype,cdt", [
    (66, torch.float32, torch.bfloat16), (128, torch.bfloat16, torch.bfloat16),
    (194, torch.bfloat16, torch.bfloat16), (128, torch.float32, torch.float32),
    (88, torch.float32, torch.float32)], ids=["in66-bf16", "128-bf16", "194-bf16", "128-f32",
                                              "in88-f32"])
def test_decoder_kernels_match_plain_on_card(cuda_device, C, x_dtype, cdt, act):
    """H-dstat, H-dfwd and H-dbwd against their plain versions on one
    stage's inputs (5,003 rows: a ragged last tile). H-dstat: the Gram and
    the column sums within 1e-5 of their largest |entry| (float32 sums in
    another order), two runs bit-identical. H-dfwd: bfloat16 within one
    ulp of the output's largest magnitude (the product's sum order may flip
    a rounding), float32 within 1e-5 of it. H-dbwd: du within one ulp of
    each element, the bias gradient within 1e-5 of the largest column's
    sum of |du|, two runs bit-identical. One launch each per call."""
    _hold_decoder_kernels(*_decoder_stage_inputs(cuda_device, C, x_dtype, cdt, 5003), act)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["softplus", "relu"])
@pytest.mark.parametrize("C,x_dtype,cdt,H", DECODER_WIDTHS,
                         ids=[f"{c}-{str(d)[6:]}-h{h}" for c, _, d, h in DECODER_WIDTHS])
def test_decoder_kernels_match_plain_on_card_at_other_widths(cuda_device, C, x_dtype, cdt, H,
                                                             act):
    """As test_decoder_kernels_match_plain_on_card (its bounds, 5,003 rows)
    at the other widths the JAX decoder takes (F15)."""
    _hold_decoder_kernels(*_decoder_stage_inputs(cuda_device, C, x_dtype, cdt, 5003, H), act)


def _hold_decoder_kernels(x, Wp, bp, cot, act):
    from gaussianavatar_torch.ops import decoder_stage as ds
    from gaussianavatar_torch.utils import cuda_build

    cdt, H = Wp.dtype, Wp.shape[1]
    before = dict(cuda_build.LAUNCHES)
    s1, g1 = ds.column_stats(x)
    s2, g2 = ds.column_stats(x)
    sp, gp = ds.column_stats_plain(x)
    assert torch.equal(s1, s2) and torch.equal(g1, g2)
    assert float((g1 - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
    assert float((s1 - sp).abs().max()) <= 1e-5 * float(sp.abs().max())

    z = ds.stage_fwd(x, Wp, bp, act)
    zp = ds.stage_fwd_plain(x, Wp, bp, act)
    assert z.dtype == cdt and z.shape == (x.shape[0], H)
    tol = float(_ulp(zp.abs().max())) if cdt == torch.bfloat16 else \
        1e-5 * float(zp.abs().max())
    assert float((z.float() - zp.float()).abs().max()) <= tol

    du1, db1 = ds.stage_bwd(cot, zp, act)
    du2, db2 = ds.stage_bwd(cot, zp, act)
    dup, dbp = ds.stage_bwd_plain(cot, zp, act)
    assert torch.equal(du1, du2) and torch.equal(db1, db2)
    assert bool(((du1.float() - dup.float()).abs() <= _ulp(dup)).all())
    scale = float(dup.float().abs().sum(0).max())
    assert float((db1 - dbp).abs().max()) <= 1e-5 * scale
    assert cuda_build.launches_since(before) == {
        **{k: 0 for k in cuda_build.LAUNCHES}, "decoder_stats": 2, "decoder_stage_fwd": 1,
        "decoder_stage_bwd": 2}


@pytest.mark.gpu
def test_decoder_kernel_rules_on_card(cuda_device):
    """The decoder kernels refuse CPU tensors, wrong types, shapes and
    unaligned tensors instead of running; the widths 128 does not cover
    (an output slice of 64, an odd input of 127, a gradient of 96) run and
    match their plain versions one for one."""
    from gaussianavatar_torch.ops import decoder_stage as ds
    from gaussianavatar_torch.utils import cuda_build

    x, Wp, bp, cot = _decoder_stage_inputs(cuda_device, 128, torch.bfloat16, torch.bfloat16, 256)
    before = dict(cuda_build.LAUNCHES)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)[1:].view_as(x)
    bad = [lambda: ds.column_stats(x.half()),
           lambda: ds.column_stats(shifted),
           lambda: ds.stage_fwd(x, Wp.float(), bp.float(), "softplus"),   # bf16 x, f32 mode
           lambda: ds.stage_fwd(x, Wp, bp, "gelu"),
           lambda: ds.stage_bwd(cot, cot.float(), "softplus"),
           lambda: ds.stage_bwd(cot, cot.cpu(), "relu")]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert cuda_build.launches_since(before) == {k: 0 for k in cuda_build.LAUNCHES}

    # the widths H-dfwd and H-dbwd refused before F15's repair
    W64, x127, c96 = Wp[:, :64].contiguous(), x[:, :127].contiguous(), cot[:, :96].contiguous()
    for z, zp in ((ds.stage_fwd(x, W64, bp[:64], "softplus"),
                   ds.stage_fwd_plain(x, W64, bp[:64], "softplus")),
                  (ds.stage_fwd(x127, Wp[:127], bp, "softplus"),
                   ds.stage_fwd_plain(x127, Wp[:127], bp, "softplus"))):
        assert float((z.float() - zp.float()).abs().max()) <= float(_ulp(zp.abs().max()))
    du, db = ds.stage_bwd(c96, c96, "relu")
    dup, dbp = ds.stage_bwd_plain(c96, c96, "relu")
    assert bool(((du.float() - dup.float()).abs() <= _ulp(dup)).all())
    assert float((db - dbp).abs().max()) <= 1e-5 * float(dup.float().abs().sum(0).max())
    assert cuda_build.launches_since(before) == {
        **{k: 0 for k in cuda_build.LAUNCHES}, "decoder_stage_fwd": 2, "decoder_stage_bwd": 1}
