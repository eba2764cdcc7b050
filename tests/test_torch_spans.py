"""The program's spans (utils/spans.py), on the CPU, with the marker
launcher replaced by a recorder that runs on any device:

  - one training step opens and closes its spans as a tree: `train::step`
    holds the decode, the posing, the raster spans, the loss, the backward
    and the optimizer, and `train::backward` holds the blend's backward, the
    scatter and `train::decode_bwd`;
  - the S-step dispatch under a fake capture: the markers are launched at
    the eager run and at the capture (a replay runs none on the host), and
    the kernels' launch counts (cuda_build.LAUNCHES) are those without them;
  - every span the package opens has both markers in csrc/span_marks.cu,
    and no marker's name holds a kernel name that readers match;
  - the identity that opens `train::decode_bwd` leaves the step's
    gradients and update bit for bit as they are without it;
  - the reader pairs nested and replayed markers and measures busy time.
"""

import os
import re
from os.path import dirname, join

import numpy as np
import pytest
import torch

from gaussianavatar_torch.config import OptimizationParams
from gaussianavatar_torch.engine import train_step as ts
from gaussianavatar_torch.engine.optim import build_optimizer
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.ops import rasterize_tile
from gaussianavatar_torch.ops.camera import Camera
from gaussianavatar_torch.ops.rasterize import RasterizeConfig
from gaussianavatar_torch.utils import cuda_build, spans
from gaussianavatar_torch.utils.synthetic import synthetic_body, synthetic_pose

torch.set_num_threads(2)

PKG = join(dirname(dirname(os.path.abspath(__file__))), "gaussianavatar_torch")
H = W = 32
N_FRAMES, B, S = 4, 2, 2


@pytest.fixture(scope="module")
def body():
    tm, uv = synthetic_body()
    J = tm.parents.shape[0]
    assets = build_avatar_assets(tm, uv.verts, uv.uvs, uv.faces_v, uv.faces_vt,
                                 np.zeros(J * 3, np.float32), np.zeros(4, np.float32),
                                 query_res=32, pad_to=64, device="cpu")
    poses = np.stack([synthetic_pose(tm, t) for t in np.linspace(0, 1, N_FRAMES)])
    return tm, assets, poses.astype(np.float32)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cam = Camera.from_extrinsics(np.eye(3, dtype=np.float32),
                                 np.array([0.0, -0.8, 1.6], np.float32), K, H, W,
                                 device="cpu")
    rep = lambda x: np.repeat(np.asarray(x, np.float32)[None], B, 0)
    return [{"pose_idx": rng.choice(N_FRAMES, B, replace=False).astype(np.int32),
             "world_view_transform": rep(cam.world_view_transform),
             "full_proj_transform": rep(cam.full_proj_transform),
             "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)} for _ in range(n)]


def _port(body, make=ts.make_train_step, **kw):
    """A fresh stage-1 port network (torch's initialisation from seed 0),
    its state and its step (or S-step dispatch, `make`)."""
    tm, assets, poses = body
    torch.manual_seed(0)
    net = AvatarNet(num_frames=N_FRAMES, pose_dim=poses.shape[1], c_geom=8,
                    inp_posmap_size=16, hsize=16, pose_init=poses.copy(), init="torch",
                    device="cpu")
    state = ts.TrainState(net, build_optimizer(net, OptimizationParams(), steps_per_epoch=2,
                                               train_stage=1), 1000)
    gt = torch.tensor(np.random.default_rng(1).integers(0, 256, (N_FRAMES, 3, H, W)),
                      dtype=torch.uint8)
    step = make(net, tm, assets, OptimizationParams(), H, W, (1.0, 1.0, 1.0),
                RasterizeConfig(16, 16), gt, **kw)
    return state, step


@pytest.fixture
def recorded(monkeypatch):
    """Every marker launch, (name, end), on any device."""
    log = []

    def record(name, end, device):
        log.append((name, bool(end)))
    monkeypatch.setattr(spans, "mark", record)
    monkeypatch.setattr(ts, "mark", record)
    return log


def _tree(log):
    """The recorded markers as a tree -> {span: set of the spans it
    directly holds}; raises unless every begin has its end, in order."""
    stack, inside = [], {}
    for name, end in log:
        if not end:
            inside.setdefault(name, set())
            if stack:
                inside.setdefault(stack[-1], set()).add(name)
            stack.append(name)
        else:
            assert stack and stack[-1] == name, (name, stack)
            stack.pop()
    assert not stack, stack
    return inside


def test_a_training_step_opens_its_spans_as_a_tree(body, recorded):
    state, step = _port(body)
    step(state, _batches(1)[0], 1.0, 1.0)
    tree = _tree(recorded)
    assert tree["train::step"] == {
        "train::decode", "render::pose_gaussians", "render::attributes", "render::projection",
        "render::binning", "render::blend", "render::untile", "train::loss", "train::backward",
        "train::optimizer"}
    assert tree["train::backward"] == {"render::blend_bwd", "render::scatter_bwd",
                                       "train::decode_bwd"}
    # the decoder's backward follows the blend's: it opens after the scatter
    names = [n for n, end in recorded if not end]
    assert names.index("train::decode_bwd") > names.index("render::scatter_bwd")


class FakeGraph(ts.GraphReplay):
    """GraphReplay with the card taken out: the capture runs `fn`, a replay
    runs nothing (only the counts and the markers mean anything)."""

    def _capture(self, fn, generators):
        return fn()

    def _replay(self):
        pass

    @staticmethod
    def warm(fn):
        return fn()


def test_markers_are_launched_at_capture_and_not_counted(body, recorded, monkeypatch):
    for fn_name, kernel in (("blend_tiles", "blend_fwd"), ("blend_tiles_bwd", "blend_bwd")):
        real = getattr(rasterize_tile, fn_name)

        def stub(*a, _real=real, _kernel=kernel, **kw):
            cuda_build.LAUNCHES[_kernel] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(rasterize_tile, fn_name, stub)
    launches = dict.fromkeys(cuda_build.SOURCES, 0)
    monkeypatch.setattr(cuda_build, "LAUNCHES", launches)
    state, steps = _port(body, ts.make_train_steps, steps=S, graph_cls=FakeGraph)
    batches = _batches(S)
    steps(state, batches, 1.0, 1.0)
    # the first dispatch: S eager steps, then S more while the graph is captured
    assert sum(1 for n, end in recorded if n == "train::step" and not end) == 2 * S
    _tree(recorded)
    del recorded[:]
    steps(state, batches, 1.0, 1.0)
    steps(state, batches, 1.0, 1.0)
    # a replay launches the graph's markers on the device, none from the host
    assert recorded == [("train::feeds", False), ("train::feeds", True),
                        ("train::replay", False), ("train::replay", True)] * 2
    assert set(launches) == set(cuda_build.SOURCES) and cuda_build.MARKERS not in launches
    assert launches == {**dict.fromkeys(cuda_build.SOURCES, 0), "blend_fwd": 3 * S,
                        "blend_bwd": 3 * S}


def _opened_in_package():
    """Every span name the package passes to span(), mark() or
    begin_in_backward()."""
    found = set()
    call = re.compile(r"\b(?:span|mark|begin_in_backward)\(\s*\"([^\"]+)\"")
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                found |= set(call.findall(open(join(root, f)).read()))
    return found


def test_every_span_has_its_markers():
    src = open(join(PKG, "csrc", "span_marks.cu")).read()
    listed = re.findall(r"^\s*X\((\w+)\)", src, flags=re.M)
    opened = _opened_in_package()
    assert len(set(listed)) == len(listed)
    assert {spans.kernel_name(n) for n in opened} == set(listed)
    for n in listed:
        for edge in "be":
            symbol = f"ga_span__{n}__{edge}"
            assert spans.MARKER.fullmatch(symbol).groups() == (n, edge)
            assert "blend_fwd_kernel" not in symbol and "blend_bwd_kernel" not in symbol
    assert "ga_span__##n##__b" in src and "ga_span__##n##__e" in src


def test_decode_bwd_identity_changes_no_bit(body, monkeypatch):
    """One step with the identity and one without, from the same network on
    the same batch: every gradient and every updated parameter equal."""
    batch = _batches(1, seed=3)[0]
    out = []
    for identity in (True, False):
        if not identity:
            monkeypatch.setattr(ts, "begin_in_backward", lambda name, device, *xs: xs)
        state, step = _port(body)
        terms, _ = step(state, batch, 1.0, 1.0)
        net = state.net
        out.append(({n: p.grad.clone() for n, p in net.named_parameters()
                     if p.grad is not None},
                    {n: p.detach().clone() for n, p in net.named_parameters()},
                    float(terms["total"])))
    (g1, p1, l1), (g2, p2, l2) = out
    assert l1 == l2 and g1.keys() == g2.keys() and len(g1) > 10
    assert all(torch.equal(g1[n], g2[n]) for n in g1)
    assert all(torch.equal(p1[n], p2[n]) for n in p1)


@pytest.mark.parametrize("case", ["nested", "replayed"])
def test_reader_pairs_markers_and_measures_busy_time(case):
    b = lambda n, t: (f"ga_span__{n}__b", t, 1.0)
    e = lambda n, t: (f"ga_span__{n}__e", t, 1.0)
    k = lambda t, d: ("void some_kernel<float>()", t, d)
    if case == "nested":
        ops = [b("train_step", 0), k(2, 5), b("train_decode", 8), k(10, 10), e("train_decode", 21),
               k(30, 4), e("train_step", 40)]
        assert spans.device_spans(ops) == {"train_step": [(0, 41)], "train_decode": [(8, 22)]}
        # busy: the kernels alone; idle: the time no operation (a marker
        # neither) ran
        assert spans.span_times(ops) == {"train_step": (1, 19.0, 41.0 - 19.0 - 4.0),
                                         "train_decode": (1, 10.0, 14.0 - 10.0 - 2.0)}
    else:
        ops = []
        for i in range(8):
            t = 100.0 * i
            ops += [b("train_step", t), k(t + 2, 30), k(t + 20, 20), e("train_step", t + 50)]
        got = spans.device_spans(ops)
        assert got["train_step"] == [(100.0 * i, 100.0 * i + 51) for i in range(8)]
        assert spans.span_times(ops) == {"train_step": (8, 8 * 38.0, 8 * (51.0 - 38.0 - 2.0))}
        assert spans.span_times(ops, since=300, until=551) == {"train_step": (3, 3 * 38.0,
                                                                              3 * 11.0)}
    with pytest.raises(ValueError, match="no end"):
        spans.device_spans(ops[:-1])
    # the profiler can lose the first operation of its trace: a first begin
    # marker lost opens at the first operation left
    assert spans.device_spans(ops[1:])["train_step"][0] == (2.0, 41.0 if case == "nested"
                                                           else 51.0)
    with pytest.raises(ValueError, match="with no begin"):
        spans.device_spans(ops + ops[-1:])
