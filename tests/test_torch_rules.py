"""Rules of the port: it imports nothing of JAX, its entry points run on the
card unless asked for the CPU and never fall back on their own, its config
and checkpoint files interoperate, and H-fwd and H-bwd build, count their
launches, refuse what they do not take and match their plain versions on
the card (those tests skip without CUDA)."""

import ast
import dataclasses
import json
import os
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


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    import inspect

    from gaussianavatar_torch import render_novel_pose, train
    from gaussianavatar_torch.engine import inference, loop

    assert inspect.signature(inference.load_trained).parameters["device"].default == "cuda"
    assert inspect.signature(loop.train).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.Config(tconfig.ModelParams(model_path=str(tmp_path)), tconfig.NetworkParams(),
                         tconfig.OptimizationParams(), tconfig.RasterParams())
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        inference.load_trained(cfg)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        render_novel_pose.main(["-m", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train.main(["-s", str(tmp_path), "-m", str(tmp_path / "out")])


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
    note = tconfig.ignored_raster_note()
    assert "ragged_budget" in note and "auto_cascade" in note and "tile_size" not in note


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
    assert cuda_build.LAUNCHES["blend_bwd"] == before + 1
