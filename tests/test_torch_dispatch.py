"""The S-step dispatch (`--steps_per_dispatch`, engine/train_step.
make_train_steps) and the JAX loop's group semantics (engine/loop.
epoch_groups), on the CPU:

  (a) the port's S=4 dispatch against the JAX `make_train_step_scan` on the
      same stacked batches from one JAX `init_state` (bridge.
      train_state_from_jax), its Pallas tile kernels in interpret mode as in
      test_torch_train: stage 1 with the group straddling iteration 1000
      (the scale warm-up's device select), stage 1 through the fused
      decoder, stage 2. Tolerances are test_torch_train's trajectory ones;
  (b) the dispatch against S single steps of `make_train_step`, bit for bit
      (one step body, the same order);
  (c) the group plan, the log and dump steps against a transcription of the
      JAX loop (gaussianavatar_tpu/engine/loop.py:490-546), whose lines the
      test reads from the source; and the CLI logging and dumping what the
      plan says;
  (d) the launch accounting of a captured graph under a fake capture (the
      kernels' counters stubbed: no card), and a capture that fails raising.
"""

import json
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.config import OptimizationParams as JOpt
from gaussianavatar_tpu.engine.optim import build_optimizer as j_build_optimizer
from gaussianavatar_tpu.engine.train_step import init_state, make_train_step_scan
from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
from gaussianavatar_tpu.utils.synthetic import synthetic_pose

from gaussianavatar_torch import bridge
from gaussianavatar_torch.config import OptimizationParams
from gaussianavatar_torch.engine import loop, train_step as ts
from gaussianavatar_torch.engine.optim import build_optimizer
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.ops import rasterize_tile
from gaussianavatar_torch.utils import cuda_build
from gaussianavatar_torch.utils.synthetic import synthetic_body

from test_torch_train import JCFG, TCFG, _TX0, _loose

torch.set_num_threads(2)

H = W = 32
N_FRAMES, B, S = 4, 2, 4
FROZEN = ("geo_feature", "pose_embedding", "transl_embedding")
# (a)'s cases: train stage, decoder, the iteration before the group
CASES = {"stage1_warmup": (1, "ref", 998), "stage1_fused": (1, "fused", 998),
         "stage2": (2, "ref", 20)}
to_np = lambda t: jax.tree.map(np.asarray, t)


def _net_kw(stage):
    kw = dict(num_frames=N_FRAMES, c_geom=8, inp_posmap_size=16, hsize=16)
    if stage == 2:
        kw.update(c_pose=8, inp_posmap_size=32, nf=4, train_stage=2)
    return kw


def _inputs(stage, seed, groups=1):
    """The GT bank, stage 2's posmaps and S batches a group, from numpy."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(0, 256, size=(N_FRAMES, 3, H, W)).astype(np.uint8)
    inp = rng.normal(scale=0.4, size=(N_FRAMES, 3, 32, 32)).astype(np.float32)
    inp[:, :, :, :8] = 0.0
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                  np.array([0.0, -0.8, 1.6], np.float32), K, H, W)
    rep = lambda x: np.repeat(np.asarray(x)[None], B, 0)
    batches = [{"pose_idx": rng.choice(N_FRAMES, B, replace=False).astype(np.int32),
                "world_view_transform": rep(cam.world_view_transform),
                "full_proj_transform": rep(cam.full_proj_transform),
                "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)}
               for _ in range(S * groups)]
    return bank, inp, batches


def _port(stage, decoder_impl, sd, start_it, bank, inp, make=ts.make_train_steps, **kw):
    """A port network loaded with `sd`, its state at `start_it` and its
    dispatch (or single step, `make`)."""
    tm, uv = synthetic_body()
    J = tm.parents.shape[0]
    ta = build_avatar_assets(tm, uv.verts, uv.uvs, uv.faces_v, uv.faces_vt,
                             np.zeros(J * 3, np.float32), np.zeros(4, np.float32),
                             query_res=32, pad_to=64, device="cpu")
    net = AvatarNet(pose_dim=J * 3, device="cpu", decoder_impl=decoder_impl, **_net_kw(stage))
    net.load_state_dict(sd)
    state = ts.TrainState(net, build_optimizer(net, OptimizationParams(), steps_per_epoch=2,
                                               train_stage=stage), start_it)
    if make is ts.make_train_steps:
        kw["steps"] = S
    step = make(net, tm, ta, OptimizationParams(), H, W, (1.0, 1.0, 1.0), TCFG,
                torch.tensor(bank), train_stage=stage,
                inp_bank=torch.tensor(inp) if stage == 2 else None, **kw)
    return state, step


@pytest.fixture(scope="module", params=list(CASES))
def scan_runs(request):
    """JAX make_train_step_scan and the port's make_train_steps, S=4, from
    one JAX state on the same stacked batches. The state is JAX's
    init_state after one group of its own scan (on S more batches, drawn
    after the held group's), so Adam's moments are warm as they are at
    `start_it` in a run: from a fresh optimizer the first update of each
    element is lr g / (|g| + eps), and for an element whose gradient
    happens to lie within a few eps of 0 (3.2e-8 against eps 1e-8, 2e-6
    of its leaf's largest, in stage 1's draw) the two packages' float
    noise in g, 25% of it there, moved the parameter by 1.1e-4 after one
    step: 9.3e-5 after the group with one build of MKL's kernels and
    1.07e-4 with its AVX2 kernels (`MKL_ENABLE_INSTRUCTIONS=AVX2`), so the
    bound below held or not by the host's CPU. The port's optimizer takes
    JAX's counts and moments (bridge.optimizer_state_from_jax)."""
    stage, decoder_impl, start_it = CASES[request.param]
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    ja = j_build_assets(jm, uv.verts, uv.uvs, uv.faces_v, uv.faces_vt,
                        np.zeros(J * 3, np.float32), np.zeros(4, np.float32),
                        query_res=32, pad_to=64)
    poses = np.stack([synthetic_pose(jm, t / N_FRAMES) for t in range(N_FRAMES)])
    jnet = JAvatarNet(pose_dim=J * 3, pose_init=poses, decoder_impl=decoder_impl,
                      **_net_kw(stage))
    st0 = jax.jit(lambda key: init_state(jnet, ja, _TX0(), rng=key, batch_size=B))(
        jax.random.PRNGKey(21 + stage))
    st0 = st0.replace(iteration=jnp.int32(start_it - S))
    bank, inp, batches = _inputs(stage, 30 + stage, groups=2)
    batches, warm = batches[:S], batches[S:]
    gates = (float(np.float32(JOpt().lambda_rgl)), float(stage == 1), 0.0)

    tx = j_build_optimizer(st0.params, JOpt(), steps_per_epoch=2, train_stage=stage)
    extra = dict(train_stage=2, inp_bank=jnp.asarray(inp.transpose(0, 2, 3, 1))) \
        if stage == 2 else {}
    scan = make_train_step_scan(jnet, jm, ja, tx, JOpt(), H, W, (1.0, 1.0, 1.0), JCFG,
                                gt_bank=jnp.asarray(bank), **extra)
    stack = lambda bs: {k: jnp.stack([jnp.asarray(b[k]) for b in bs]) for k in bs[0]}
    j_gates = tuple(np.float32(g) for g in gates)
    st, _, _ = scan(st0.replace(opt_state=tx.init(st0.params)), stack(warm), *j_gates)
    assert int(st.iteration) == start_it
    params0, bs0, opt0 = to_np(st.params), to_np(st.batch_stats), to_np(st.opt_state)
    sd0 = bridge.state_dict_from_jax(params0, bs0)
    st, j_terms, j_images = scan(st, stack(batches), *j_gates)
    j_sd = bridge.state_dict_from_jax(to_np(st.params), to_np(st.batch_stats))

    tnet_sd = bridge.state_dict_from_jax(params0, bs0)
    state, steps = _port(stage, decoder_impl, tnet_sd, start_it, bank, inp)
    state.optimizer.load_state_dict(bridge.optimizer_state_from_jax(opt0))
    terms, images = steps(state, batches, *gates)
    return {"stage": stage, "decoder": decoder_impl, "start_it": start_it, "sd0": sd0,
            "j": (j_sd, {k: np.asarray(v) for k, v in j_terms.items()}, int(st.iteration),
                  np.asarray(j_images)),
            "t": ({k: v.clone() for k, v in state.net.state_dict().items()},
                  {k: v.numpy() for k, v in terms.items()}, state.iteration, images.numpy())}


def test_dispatch_matches_jax_scan(scan_runs):
    """Each step's loss terms to 1e-4 relative, the last step's images to
    1e-3 of 1 (they render parameters that already differ within the bounds
    below: 2.8e-4 measured through the fused decoder), the iteration exactly, and after the 4 steps the parameters
    and BatchNorm statistics with test_torch_train's trajectory bounds:
    geo_feature and the embeddings 2e-5 absolute, the running variances
    1e-5 relative, the BatchNorm-absorbed Dense biases 2 x lr_net a step
    (and the running means that follow them), the rest 1e-4. Through the
    fused decoder, whose gradients agree with JAX's to 1e-4 of their
    largest (test_torch_fused_decoder), the parameters other than those
    biases are held by their move: stated where asserted. Stage 2's
    frozen tensors do not move. The JAX scan test itself holds S steps
    against sequential ones to rtol 1e-5 on the total
    (tests/test_train_step.py:354-356)."""
    j_sd, j_terms, j_it, j_images = scan_runs["j"]
    t_sd, t_terms, t_it, t_images = scan_runs["t"]
    assert t_it == j_it == scan_runs["start_it"] + S
    if scan_runs["stage"] == 1:
        # the group straddles iteration 1000: the warm-up's two branches
        assert scan_runs["start_it"] < 1000 <= scan_runs["start_it"] + S
    assert set(t_terms) == set(j_terms)
    for k, v in j_terms.items():
        assert t_terms[k].shape == (S,), k
        np.testing.assert_allclose(t_terms[k], v, rtol=1e-4, atol=1e-9, err_msg=k)
    assert t_images.shape == (B, 3, H, W)
    np.testing.assert_allclose(t_images, j_images.reshape(t_images.shape), rtol=0, atol=1e-3)
    lr = JOpt().lr_net
    fused = scan_runs["decoder"] == "fused"
    for name, jv in j_sd.items():
        tv, jv = t_sd[name].numpy(), jv.numpy()
        if scan_runs["stage"] == 2 and name in FROZEN:
            assert np.array_equal(tv, scan_runs["sd0"][name].numpy()), name
            continue
        if fused and not _loose(name) and not name.endswith(("running_mean", "running_var")):
            # Adam divides each gradient entry by its own root moment, so the
            # fused decoder's gradient noise (1e-4 of the largest, against
            # JAX's fused decoder) moves an entry near 0 by up to a step;
            # each tensor's move over the S steps to 5% of JAX's (1.4e-2
            # measured, pose_embedding), every entry within one step of the
            # largest rate (lr_pose) a step
            v0 = scan_runs["sd0"][name].numpy()
            move = np.linalg.norm(jv - v0)
            assert np.linalg.norm(tv - jv) <= 5e-2 * move, name
            np.testing.assert_allclose(tv, jv, rtol=0, atol=JOpt().lr_pose * S, err_msg=name)
            continue
        if name in FROZEN:
            tol = 2e-5
        elif name.endswith("running_var"):
            tol = 1e-5 * np.abs(jv).max()
        elif name.endswith("running_mean"):
            tol = 1e-5 * np.abs(jv).max() + 0.2 * lr * S * (S - 1)
        elif _loose(name):
            tol = 2 * lr * S
        else:
            tol = 1e-4
        np.testing.assert_allclose(tv, jv, rtol=0, atol=tol, err_msg=name)


def _port_sd(stage, decoder_impl, seed=0):
    g = torch.Generator().manual_seed(seed)
    tm, _ = synthetic_body()
    rng = np.random.default_rng(seed)
    pose = (rng.normal(scale=0.1, size=(N_FRAMES, tm.parents.shape[0] * 3))
            .astype(np.float32))
    net = AvatarNet(pose_dim=pose.shape[1], pose_init=pose, generator=g, device="cpu",
                    decoder_impl=decoder_impl, **_net_kw(stage))
    return {k: v.clone() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("stage", [1, 2])
def test_dispatch_is_s_single_steps_bit_for_bit(stage):
    """One S=4 dispatch and four single steps from the same state (stage 1
    across iteration 1000): every term of every step, every parameter,
    BatchNorm statistic, optimizer moment and count, and the iteration,
    equal to the bit. On the CPU the dispatch runs the same step body in
    the same order."""
    start_it = 998 if stage == 1 else 20
    sd = _port_sd(stage, "ref")
    bank, inp, batches = _inputs(stage, 40 + stage)
    gates = (float(np.float32(JOpt().lambda_rgl)), float(stage == 1), 0.0)
    st_a, steps = _port(stage, "ref", sd, start_it, bank, inp)
    terms_a, images_a = steps(st_a, batches, *gates)
    st_b, step = _port(stage, "ref", sd, start_it, bank, inp, make=ts.make_train_step)
    outs = [step(st_b, b, *gates) for b in batches]
    assert st_a.iteration == st_b.iteration == start_it + S
    for k, v in terms_a.items():
        assert torch.equal(v, torch.stack([t[k] for t, _ in outs])), k
    assert torch.equal(images_a, outs[-1][1])
    for (k, a), (_, b) in zip(st_a.net.state_dict().items(), st_b.net.state_dict().items()):
        assert torch.equal(a, b), k
    opt_a, opt_b = st_a.optimizer.state_dict(), st_b.optimizer.state_dict()
    for group, g in opt_a.items():
        for key, v in g.items():
            if isinstance(v, dict):
                for name, t in v.items():
                    assert torch.equal(t, opt_b[group][key][name]), (group, key, name)
            else:
                assert int(v) == int(opt_b[group][key]), (group, key)
    assert {g["count"] for g in opt_a.values() if "count" in g} == {S}


# --------------------------------------------------------------------------
# (c) the group plan against the JAX loop
# --------------------------------------------------------------------------

JAX_LOOP = join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "gaussianavatar_tpu", "engine", "loop.py")
# the JAX loop's lines that decide the groups, the logs and the dumps
JAX_LINES = (
    "target = spd if multi_fn is not None else 1",
    "target = max(min(target, max_steps - first_iter), 1)",
    "if len(feeds) == target:",
    "if multi_fn is not None and len(feeds) == spd:",
    "if first_iter % 10 < spd or first_iter <= epoch_start * steps_per_epoch + spd:",
    "if (first_iter - 1) % opt.log_iter < spd:",
    "if max_steps is not None and first_iter >= max_steps:",
)


def _jax_epoch(n_batches, spd, first_iter, base, log_iter, max_steps):
    """One epoch of gaussianavatar_tpu/engine/loop.py:490-546 with the steps
    elided: -> [(size, dispatch, first_iter after, log, dump)], done."""
    multi = spd > 1
    feed_iter = iter(range(n_batches))
    out = []
    while True:
        target = spd if multi else 1
        if max_steps is not None:
            target = max(min(target, max_steps - first_iter), 1)
        feeds = []
        for feed in feed_iter:
            feeds.append(feed)
            if len(feeds) == target:
                break
        if not feeds:
            break
        dispatch = multi and len(feeds) == spd
        first_iter += len(feeds)
        out.append((len(feeds), dispatch, first_iter,
                    first_iter % 10 < spd or first_iter <= base + spd,
                    (first_iter - 1) % log_iter < spd))
        if max_steps is not None and first_iter >= max_steps:
            return out, True
    return out, False


def _run(epoch_fn, epochs, n_batches, spd, start, log_iter, max_steps):
    plan, first = [], start
    for _ in range(epochs):
        groups, done = epoch_fn(n_batches, spd, first, start, log_iter, max_steps)
        plan += groups
        first = groups[-1][2] if groups else first
        if done:
            break
    return plan


def _port_epoch(n_batches, spd, first_iter, base, log_iter, max_steps):
    groups = loop.epoch_groups(n_batches, spd, first_iter, base, log_iter, max_steps)
    done = max_steps is not None and bool(groups) and groups[-1].end >= max_steps
    return [tuple(g) for g in groups], done


def test_group_plan_is_the_jax_loops():
    """Full groups, epochs shorter than S and not a multiple of it, the
    `max_steps` clamp (mid-group, mid-epoch, reached before the run), the
    log and dump steps at log_iter 2000, 5 and 3, S = 1, 4 and 8, and
    resumed runs (the run starting after iteration 30 or 37): the port's
    plan equals the JAX loop's, read off its own lines."""
    src = open(JAX_LOOP).read()
    for line in JAX_LINES:
        assert line in src, line
    cases = 0
    for spd in (1, 4, 8):
        for n_batches in (1, 3, 4, 8, 24, 25):
            for start in (0, 30, 37):
                for max_steps in (None, start + 5, start + 12, start + 50, start):
                    for log_iter in (2000, 5, 3):
                        args = (6, n_batches, spd, start, log_iter, max_steps)
                        assert _run(_port_epoch, *args) == _run(_jax_epoch, *args), args
                        cases += 1
    assert cases == 810
    # the canonical campaign: 24 batches an epoch, three dispatches of 8,
    # logged after 8, 16, 24 (24 % 10 = 4 < 8) and dumped after the first
    groups = loop.epoch_groups(24, 8, 0, 0, 2000)
    assert [(g.size, g.dispatch, g.end, g.log, g.dump) for g in groups] == [
        (8, True, 8, True, True), (8, True, 16, True, False), (8, True, 24, True, False)]


def test_cli_logs_and_dumps_the_plan(tmp_path, monkeypatch):
    """The training CLI at --steps_per_dispatch 4 on 4 batches an epoch:
    each epoch one dispatch of 4 steps (counted), metrics.jsonl's steps and
    the debug dumps as the plan says, the save holding iteration 12."""
    from gaussianavatar_torch import train
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine import checkpoint as tckpt

    from test_torch_train_cli import SMALL_ARGS

    calls = []
    real = loop.make_train_steps

    def counted(*a, **kw):
        fn = real(*a, **kw)

        def dispatch(state, feeds, *g):
            calls.append((state.iteration, len(feeds)))
            return fn(state, feeds, *g)
        return dispatch

    monkeypatch.setattr(loop, "make_train_steps", counted)
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    write_synthetic_dataset(data, n_train=8, n_test=1, image_size=32, device="cpu")
    train.main(["-s", data, "-m", out, "--device", "cpu", "--epochs", "3", "--save_epochs", "0",
                "--steps_per_dispatch", "4", "--log_iter", "5", "--no_lpips"] + SMALL_ARGS)
    assert calls == [(0, 4), (4, 4), (8, 4)]
    plan = _run(_port_epoch, 3, 4, 4, 0, 5, None)
    records = [json.loads(line) for line in open(join(out, "metrics.jsonl"))]
    assert [r["step"] for r in records if "step" in r] == [g[2] for g in plan if g[3]] == [4, 12]
    dumps = [g[2] for g in plan if g[4]]
    assert dumps == [4, 8, 12]
    assert sorted(os.listdir(join(out, "log"))) == sorted(
        f for it in dumps for f in (f"{it:05d}_gt.png", f"{it:05d}_pred.png",
                                    f"pred_{it:05d}.ply"))
    saved = torch.load(join(tckpt.ckpt_dir(out, 3), tckpt.TRAIN_NAME), weights_only=True)
    assert saved["iteration"] == 12 and saved["optimizer"]["net"]["count"] == 12


# --------------------------------------------------------------------------
# (d) the launch accounting of a captured graph, under a fake capture
# --------------------------------------------------------------------------

class FakeGraph(ts.GraphReplay):
    """GraphReplay with the card taken out: the capture runs `fn` (so the
    stubbed wrappers count, as they do while a real graph is captured), a
    replay runs nothing. Only the counts mean anything here."""

    def _capture(self, fn, generators):
        return fn()

    def _replay(self):
        pass

    @staticmethod
    def warm(fn):
        return fn()


@pytest.fixture
def counted_kernels(monkeypatch):
    """The blend wrappers on the CPU, each adding one to its kernel's count
    as the CUDA wrappers do where they launch."""
    for fn_name, kernel in (("blend_tiles", "blend_fwd"), ("blend_tiles_bwd", "blend_bwd")):
        real = getattr(rasterize_tile, fn_name)

        def stub(*a, _real=real, _kernel=kernel, **kw):
            cuda_build.LAUNCHES[_kernel] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(rasterize_tile, fn_name, stub)
    monkeypatch.setattr(cuda_build, "LAUNCHES", dict.fromkeys(cuda_build.SOURCES, 0))
    return cuda_build.LAUNCHES


def test_graph_launches_counts_once_per_replay(counted_kernels):
    """GraphLaunches: what a capture counts leaves LAUNCHES and becomes the
    graph's; each replay adds it back."""
    gl = cuda_build.GraphLaunches()
    counted_kernels["blend_fwd"] = 5
    with gl.capturing():
        counted_kernels["blend_fwd"] += 3
        counted_kernels["decoder_stats"] += 9
    assert gl.per_replay == {"blend_fwd": 3, "decoder_stats": 9}
    assert counted_kernels["blend_fwd"] == 5 and counted_kernels["decoder_stats"] == 0
    gl.replayed()
    gl.replayed()
    assert counted_kernels["blend_fwd"] == 11 and counted_kernels["decoder_stats"] == 18


def test_dispatch_counts_launches_under_a_fake_capture(counted_kernels, capsys):
    """Three S=4 dispatches through a fake graph: the first runs eagerly
    (4 launches of each blend kernel) and captures (4 more counted by the
    wrappers, taken out again), the next two replay (4 each, counted by the
    replay): 12 of each, exactly one a step. A gate flip captures again."""
    bank, inp, batches = _inputs(1, 50)
    state, steps = _port(1, "ref", _port_sd(1, "ref"), 0, bank, inp, graph_cls=FakeGraph)
    for _ in range(3):
        steps(state, batches, 1.0, 1.0, 0.0)
    assert counted_kernels["blend_fwd"] == counted_kernels["blend_bwd"] == 3 * S
    assert "captured a CUDA graph of 4 training steps (pose gate on" in capsys.readouterr().out
    steps(state, batches, 1.0, 0.0, 0.0)   # the pose gate flips: eager, a new capture
    steps(state, batches, 1.0, 0.0, 0.0)
    assert counted_kernels["blend_fwd"] == counted_kernels["blend_bwd"] == 5 * S
    assert "(pose gate off" in capsys.readouterr().out
    assert state.iteration == 5 * S


def test_capture_failure_raises():
    """A capture that fails (here: a host read inside it) raises with the
    reason; the dispatch does not go on eagerly."""
    class Refusing(FakeGraph):
        def _capture(self, fn, generators):
            raise RuntimeError("operation not permitted when stream is capturing")

    bank, inp, batches = _inputs(1, 51)
    state, steps = _port(1, "ref", _port_sd(1, "ref"), 0, bank, inp, graph_cls=Refusing)
    with pytest.raises(RuntimeError, match="does not fall back"):
        steps(state, batches, 1.0, 1.0, 0.0)
