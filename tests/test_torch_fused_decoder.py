"""Port parity, the fused POP decoder (`--fused_decoder 1`): the port's
`ShapeDecoderFused` (models/decoder.py; on the CPU its three kernels' plain
versions, ops/decoder_stage.py) against the JAX package's
`gaussianavatar_tpu.models.decoder.ShapeDecoderFused`, on the same
variables converted by gaussianavatar_torch.bridge and the same numpy
inputs.

Bounds. float32: outputs and BatchNorm statistics within 1e-5 of each
output's largest magnitude (at least 1e-5 absolute), gradients within 1e-4
of each leaf's largest |gradient| (the Dense biases that feed a BatchNorm,
true gradient 0, within 1e-6 of the net's largest; the two differ by
summation order; the
statistics' Gram is summed in float64 by the port's plain version and in
float32 by XLA). bfloat16: outputs within 2^-8 (BF16_ATOL of
tests/test_torch_decoder.py, one bf16 ulp at 1.0), statistics within
1e-4, gradients' cosine >= 0.999 (the two round bf16 products and their
backward at their own places). The JAX-reference-variables interop holds
at tests/test_layers.py's own 5e-3. The train step and `--dp 2` hold at
the bounds of tests/test_torch_train.py and tests/test_torch_frame_dp.py,
through that module's fixture run with the fused decoder."""

import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.models.decoder import ShapeDecoderFused as JShapeDecoderFused
from gaussianavatar_tpu.models.pop import POPDecoder as JPOPDecoder

from gaussianavatar_torch import bridge
from gaussianavatar_torch.models.decoder import ShapeDecoder, ShapeDecoderFused
from gaussianavatar_torch.models.pop import POPDecoder
from gaussianavatar_torch.ops import decoder_stage as ds

import test_torch_frame_dp as frame_dp
from test_torch_stage2_cli import SMALL_ARGS

torch.set_num_threads(2)

BF16_ATOL = 2.0**-8
CPU = ["--device", "cpu"]


def _np(t):
    return t.detach().float().numpy()


def _random_stats(stats, seed):
    rng = np.random.default_rng(seed)
    return {name: {"mean": rng.normal(scale=0.3, size=np.asarray(s["mean"]).shape[0])
                   .astype(np.float32),
                   "var": rng.uniform(0.5, 2.0, size=np.asarray(s["var"]).shape[0])
                   .astype(np.float32)} for name, s in stats.items()}


def _pair(dtype, act, seed=0, in_size=10, hsize=16, rows=300):
    """The JAX fused decoder's variables (non-trivial running statistics),
    the port's fused decoder loaded with them, and an input (2, rows, in)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, rows, in_size)).astype(np.float32)
    jm = JShapeDecoderFused(hsize=hsize, compute_dtype=dtype, actv_fn=act)
    v = jm.init(jax.random.PRNGKey(seed + 3), jnp.asarray(x))
    params = jax.tree.map(np.asarray, v["params"])
    stats = _random_stats(jax.tree.map(np.asarray, v["batch_stats"]), seed + 4)
    tm = ShapeDecoderFused(in_size, hsize=hsize, compute_dtype=dtype, actv_fn=act)
    tm.load_state_dict(bridge.shape_decoder_state_dict(params, stats))
    return jm, params, stats, tm, x


def _jax_f32(act, in_size, hsize, params, stats, x, train):
    """The JAX fused decoder's outputs at float32 on the same variables (and
    in training, its updated running statistics as port keys)."""
    jm = JShapeDecoderFused(hsize=hsize, compute_dtype="float32", actv_fn=act)
    out = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=train,
                   mutable=["batch_stats"] if train else False)
    if not train:
        return [np.asarray(o) for o in out]
    new = bridge.shape_decoder_state_dict(params, jax.tree.map(np.asarray,
                                                               out[1]["batch_stats"]))
    return [np.asarray(o) for o in out[0]], new


def _loss(xyz, sc, sh):
    return (xyz ** 2).sum() + sc.sum() + sh.sum()


@pytest.mark.parametrize("act", ["softplus", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_decoder_training_matches_jax(dtype, act):
    """Training mode: the outputs, the updated running statistics, and the
    gradient of every parameter and of the input (through the batch
    statistics too) against the JAX ShapeDecoderFused."""
    _check_training(dtype, act)


# the other widths the JAX decoder takes: a wider hidden stage (hsize 96,
# whose skip stage is in + 96 wide) and an odd input width (--c_geom odd).
# At bfloat16 the two packages round the fold's Wp and bp and every stage's
# output at other places, and at these widths a flipped rounding runs on
# through the 11 BatchNorm'd stages (several ulps of the output):
# there each output and running statistic is held within twice the JAX
# bfloat16 decoder's own distance from the float32 decoder's (two draws of
# the same rounding noise), plus the stated bound (one bfloat16 ulp of the
# largest |output|; 1e-4 for the statistics). float32 holds the stated
# bounds at every width; at the default width bfloat16 agrees bit for bit.
OTHER_WIDTHS = [(10, 96), (9, 16), (9, 96)]


def _bf16_bound(name, port, jax_bf16, jax_f32):
    """The port's bfloat16 output within twice JAX bfloat16's own distance
    from the float32 decoder's, plus one ulp of the largest |output|."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jax_f32).max())) - 7)
    bound = 2 * np.abs(jax_bf16 - jax_f32).max() + ulp
    np.testing.assert_array_less(np.abs(port - jax_f32).max(), bound + 1e-12, err_msg=name)


@pytest.mark.parametrize("in_size,hsize", OTHER_WIDTHS,
                         ids=[f"in{i}-h{h}" for i, h in OTHER_WIDTHS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_decoder_training_matches_jax_at_other_widths(dtype, in_size, hsize):
    """As test_fused_decoder_training_matches_jax (softplus, its bounds) at
    the other widths."""
    _check_training(dtype, "softplus", in_size=in_size, hsize=hsize)


def _check_training(dtype, act, in_size=10, hsize=16):
    jm, params, stats, tm, x = _pair(dtype, act, in_size=in_size, hsize=hsize)
    other = (in_size, hsize) != (10, 16)

    def j_fn(p, xx):
        outs, mut = jm.apply({"params": p, "batch_stats": stats}, xx, train=True,
                             mutable=["batch_stats"])
        return _loss(*outs), (outs, mut)

    (_, (outs_j, mut_j)), (g_p, g_x) = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    outs_t = tm.train()(xt)
    _loss(*outs_t).backward()

    f32 = dtype == "float32"
    outs_f, stats_f = _jax_f32(act, in_size, hsize, params, stats, x, True) \
        if other and not f32 else (None, None)
    for i, (name, a, b) in enumerate(zip(("xyz", "scales", "shs"), outs_t, outs_j)):
        b = np.asarray(b)
        assert a.dtype == torch.float32
        if outs_f is not None:
            _bf16_bound(name, _np(a), b, outs_f[i])
            continue
        atol = 1e-5 * max(1.0, np.abs(b).max()) if f32 else BF16_ATOL
        np.testing.assert_allclose(_np(a), b, rtol=0, atol=atol, err_msg=name)
    new_stats = bridge.shape_decoder_state_dict(params, jax.tree.map(np.asarray,
                                                                     mut_j["batch_stats"]))
    for k, v in tm.state_dict().items():
        if "running" in k and stats_f is not None:
            # as the outputs: within twice JAX bfloat16's distance from float32
            far = float((new_stats[k] - stats_f[k]).abs().max())
            assert float((v - stats_f[k]).abs().max()) <= 2 * far + 1e-4, k
        elif "running" in k:
            np.testing.assert_allclose(v.numpy(), new_stats[k].numpy(), rtol=0,
                                       atol=1e-5 if f32 else 1e-4, err_msg=k)
        if "running" in k:
            assert not np.allclose(v.numpy(), bridge.shape_decoder_state_dict(
                params, stats)[k].numpy()), k  # they moved

    j_grads = bridge.shape_decoder_state_dict(jax.tree.map(np.asarray, g_p), stats)
    t_grads = {k: p.grad for k, p in tm.named_parameters()}
    t_grads["input"], j_grads["input"] = xt.grad, torch.tensor(np.asarray(g_x))
    assert set(t_grads) <= set(j_grads)
    if f32:
        scale = max(float(g.abs().max()) for g in j_grads.values())
        for k, g in t_grads.items():
            jg = j_grads[k].numpy()
            # a Dense bias that feeds a BatchNorm has true gradient 0: float
            # noise on both sides, held at 1e-6 of the net's gradient scale
            # (tests/test_torch_train.py's rule)
            loose = k.startswith("dense.") and k.endswith(".bias") and \
                k.split(".")[1] not in ("7", "10", "13")
            tol = 1e-6 * scale if loose else 1e-4 * np.abs(jg).max()
            np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=tol, err_msg=k)
    else:
        a = torch.cat([g.reshape(-1) for g in t_grads.values()])
        b = torch.cat([j_grads[k].reshape(-1) for k in t_grads])
        cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
        assert cos >= 0.999, cos
    assert float(xt.grad.abs().max()) > 0


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", BF16_ATOL)])
def test_fused_decoder_eval_matches_jax(dtype, atol):
    """Eval mode: the running statistics fold into the stages; the
    outputs against the JAX ShapeDecoderFused at train=False."""
    _check_eval(dtype, atol)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", BF16_ATOL)])
def test_fused_decoder_eval_matches_jax_at_other_widths(dtype, atol):
    """As test_fused_decoder_eval_matches_jax at an odd input width and
    hsize 96."""
    _check_eval(dtype, atol, in_size=9, hsize=96)


def _check_eval(dtype, atol, in_size=10, hsize=16):
    jm, params, stats, tm, x = _pair(dtype, "softplus", seed=5, in_size=in_size, hsize=hsize)
    outs_j = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        outs_t = tm.eval()(torch.tensor(x))
    outs_f = _jax_f32("softplus", in_size, hsize, params, stats, x, False) \
        if (in_size, hsize) != (10, 16) and dtype == "bfloat16" else None
    for i, (name, a, b) in enumerate(zip(("xyz", "scales", "shs"), outs_t, outs_j)):
        b = np.asarray(b)
        if outs_f is not None:
            _bf16_bound(name, _np(a), b, outs_f[i])
            continue
        tol = atol * max(1.0, np.abs(b).max()) if dtype == "float32" else atol
        np.testing.assert_allclose(_np(a), b, rtol=0, atol=tol, err_msg=name)


def test_fused_and_reference_decoders_share_their_state_dict():
    """ShapeDecoderFused keeps ShapeDecoder's submodules: the same keys,
    shapes and dtypes, so a checkpoint loads into either."""
    ref, fused = ShapeDecoder(66), ShapeDecoderFused(66)
    a, b = ref.state_dict(), fused.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)
    fused.load_state_dict(a)


def test_jax_reference_variables_drive_the_fused_pop_decoder():
    """A JAX POPDecoder initialised with the reference decoder: its
    variables drive the port's fused POPDecoder to the JAX fused one's
    outputs (tests/test_layers.py's interop bound, 5e-3) and running
    statistics."""
    rng = np.random.default_rng(0)
    geo = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
    uv = np.random.default_rng(1).uniform(size=(50, 2)).astype(np.float32)
    vidx = np.arange(50, dtype=np.int32)
    kw = dict(c_geom=8, geom_layer_type="conv", hsize=32)
    v_ref = JPOPDecoder(**kw).init(jax.random.PRNGKey(2), geo, uv, vidx, 32)
    outs_j, mut_j = JPOPDecoder(**kw, decoder_impl="fused").apply(
        v_ref, geo, uv, vidx, 32, train=True, mutable=["batch_stats"])
    to_np = lambda t: jax.tree.map(np.asarray, t)
    sd = bridge.state_dict_from_jax({"pop": to_np(v_ref["params"])},
                                    {"pop": to_np(v_ref["batch_stats"])})
    tm = POPDecoder(c_geom=8, geom_layer_type="conv", hsize=32, decoder_impl="fused")
    assert isinstance(tm.decoder, ShapeDecoderFused)
    tm.load_state_dict({k[len("pop."):]: v for k, v in sd.items()})
    outs_t = tm.train()(torch.tensor(geo).permute(0, 3, 1, 2), torch.tensor(uv),
                        torch.tensor(vidx, dtype=torch.int64), 32)
    for name, a, b in zip(("xyz", "scales", "shs"), outs_t, outs_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=5e-3, err_msg=name)
    new = bridge.state_dict_from_jax({"pop": to_np(v_ref["params"])},
                                     {"pop": to_np(mut_j["batch_stats"])})
    for k, v in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), new["pop." + k].numpy(), rtol=0, atol=1e-4,
                                       err_msg=k)
    with pytest.raises(ValueError, match="decoder_impl"):
        POPDecoder(decoder_impl="other")


# --------------------------------------------------------------------------
# The kernels' plain versions and the autograd Functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_column_stats_plain_is_the_float64_sums(dtype):
    """H-dstat's plain version: the column sums and x^T x, against float64
    numpy, to float32's rounding (2^-24 relative, with a little room)."""
    x = torch.tensor(np.random.default_rng(0).normal(size=(1000, 37)).astype(np.float32))
    x = x.to(dtype)
    s, g = ds.column_stats_plain(x)
    xd = x.double().numpy()
    assert s.dtype == g.dtype == torch.float32 and g.shape == (37, 37)
    np.testing.assert_allclose(s.numpy(), xd.sum(0), rtol=1e-7, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), xd.T @ xd, rtol=1e-7, atol=1e-6)


@pytest.mark.parametrize("act", ["softplus", "relu"])
def test_stage_plain_versions_match_the_formula(act):
    """H-dfwd's plain version against act(x Wp + bp) in float64 (1e-6
    relative); H-dbwd's, from z alone, against autograd of the activation
    at the pre-activation z came from (1e-6 of the largest |du|), and its
    bias gradient against the float64 column sums of that du."""
    rng = np.random.default_rng(1)
    x, Wp = rng.normal(size=(500, 24)), rng.normal(size=(24, 16)) / 5
    bp, g = rng.normal(size=16), rng.normal(size=(500, 16))
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    z = ds.stage_fwd_plain(f(x), f(Wp), f(bp), act)
    u = x @ Wp + bp
    ref = np.maximum(u, 0) if act == "relu" else np.logaddexp(u, 0)
    np.testing.assert_allclose(z.numpy(), ref, rtol=1e-6, atol=1e-6)

    ut = f(u).requires_grad_(True)
    zt = torch.relu(ut) if act == "relu" else torch.nn.functional.softplus(ut)
    du_ref, = torch.autograd.grad(zt, ut, f(g))
    du, dbp = ds.stage_bwd_plain(f(g), zt.detach(), act)
    np.testing.assert_allclose(du.numpy(), du_ref.numpy(), rtol=0,
                               atol=1e-6 * float(du_ref.abs().max()))
    # a float32 sum of 500 terms: within 1e-6 of each column's sum of |du|
    np.testing.assert_allclose(dbp.numpy(), du.double().sum(0).numpy(), rtol=0,
                               atol=1e-6 * float(du.abs().sum(0).max()))


@pytest.mark.parametrize("act", ["softplus", "relu"])
def test_fused_stage_functions_backward_as_autograd(act):
    """FusedStage and ColumnStats: their forward and hand-written backward
    against autograd through the plain formulas (float32; 1e-5 of each
    gradient's largest)."""
    rng = np.random.default_rng(2)
    mk = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32), requires_grad=True)
    x, Wp, bp = mk(400, 20), mk(20, 16), mk(16)
    gz, gs, gg = (torch.tensor(rng.normal(size=s).astype(np.float32))
                  for s in ((400, 16), (20,), (20, 20)))
    act_fn = torch.relu if act == "relu" else ds.softplus

    def grads(fused):
        z = ds.FusedStage.apply(x, Wp, bp, act) if fused else act_fn(x @ Wp + bp)
        s, g = ds.ColumnStats.apply(x) if fused else (x.sum(0), x.t() @ x)
        loss = (z * gz).sum() + (s * gs).sum() + (g * gg).sum()
        return torch.autograd.grad(loss, (x, Wp, bp))

    for name, a, b in zip(("x", "Wp", "bp"), grads(True), grads(False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()), err_msg=name)


# --------------------------------------------------------------------------
# The train step, unsharded and --dp 2, against JAX (test_torch_frame_dp's
# fixture run with decoder_impl="fused" on both sides)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 2], ids=["stage1", "stage2"])
def fused_runs(request, tmp_path_factory):
    return frame_dp.make_runs(request.param, tmp_path_factory, decoder_impl="fused")


def test_fused_train_step_matches_jax(fused_runs):
    """The port's unsharded step through the fused decoder against the JAX
    step with fused_decoder=1 (frame_dp's bounds: terms 1e-5 relative,
    gradients 2e-4 of each parameter's largest, the zero-gradient biases
    2e-6 of the net's scale)."""
    _check_step(fused_runs)


def test_fused_train_step_matches_jax_at_other_widths(tmp_path_factory):
    """As test_fused_train_step_matches_jax (stage 1, unsharded) at
    `--hsize 96 --c_geom 7`: an odd first stage (7 + 2 uv = 9 wide), 96-wide
    hidden stages and a 105-wide skip stage."""
    _check_step(frame_dp.make_runs(1, tmp_path_factory, decoder_impl="fused",
                                   net_kw=dict(hsize=96, c_geom=7), ranks=False))


def _check_step(fused_runs):
    _, terms, grads = fused_runs["full"]
    for k, v in fused_runs["j_terms"].items():
        np.testing.assert_allclose(terms[k], v, rtol=1e-5, atol=1e-9, err_msg=k)
    j_scale = max(float(fused_runs["j_grads"][k].abs().max()) for k in grads)
    for k, g in grads.items():
        jg = fused_runs["j_grads"][k].numpy()
        tol = 2e-6 * j_scale if frame_dp._loose(k) else 2e-4 * np.abs(jg).max()
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=tol, err_msg=k)
    assert any(k.startswith("pop.decoder.dense.") for k in grads)


def test_fused_dp_step_matches_unsharded(fused_runs):
    """--dp 2 through the fused decoder (gloo, the CPU) against the
    unsharded step: every term 1e-6, every parameter after the SGD(1.0)
    step 1e-5, the running statistics 1e-5 (frame_dp's bounds)."""
    full_sd, full_terms, _ = fused_runs["full"]
    for rank in fused_runs["ranks"]:
        sd, terms, _ = rank["sync"]
        for k, v in full_terms.items():
            np.testing.assert_allclose(terms[k], v, rtol=frame_dp.TOL_LOSS,
                                       atol=frame_dp.TOL_LOSS, err_msg=k)
        for k, v in full_sd.items():
            tol = frame_dp.TOL_BN if k.endswith(("running_mean", "running_var")) \
                else frame_dp.TOL_GRAD
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("fused_runs", [2], indirect=True, ids=["stage2"])
def test_fused_dp_needs_the_statistics_all_reduce(fused_runs):
    """The control: ranks whose fused decoder keeps its own shard's
    statistics (the UNet's BatchNorm still synced) miss the bounds the
    synced step meets: the decoder's running statistics and its update."""
    full_sd, full_terms, _ = fused_runs["full"]
    sd, terms, _ = fused_runs["ranks"][0]["nodecsync"]
    missed = [k for k, v in full_sd.items() if k.startswith("pop.decoder.") and not np.allclose(
        sd[k].numpy(), v.numpy(), rtol=frame_dp.TOL_BN, atol=frame_dp.TOL_BN)]
    assert any(k.endswith("running_var") for k in missed), missed
    assert any(k.endswith(".weight") for k in missed), missed
    assert not all(np.isclose(terms[k], v, rtol=frame_dp.TOL_LOSS, atol=frame_dp.TOL_LOSS)
                   for k, v in full_terms.items())


# --------------------------------------------------------------------------
# The CLIs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fused_cli(tmp_path_factory):
    """3 steps of `train --fused_decoder 1` on the CPU, every decoder
    wrapper call counted."""
    from gaussianavatar_torch import train
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine import loop

    root = tmp_path_factory.mktemp("fused_cli")
    data, out = str(root / "data"), str(root / "out")
    write_synthetic_dataset(data, n_train=4, n_test=2, image_size=32, device="cpu")
    calls = {n: 0 for n in ("column_stats", "stage_fwd", "stage_bwd")}
    nets = []
    real = {n: getattr(ds, n) for n in calls}
    real_step = loop.make_train_step

    def counted(name):
        def call(*a):
            calls[name] += 1
            return real[name](*a)
        return call

    def make_step(net, *a, **kw):
        nets.append(net)
        return real_step(net, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        for n in calls:
            mp.setattr(ds, n, counted(n))
        mp.setattr(loop, "make_train_step", make_step)
        train.main(["-s", data, "-m", out, "--max_steps", "3", "--no_lpips",
                    "--fused_decoder", "1"] + SMALL_ARGS + CPU)
    return {"data": data, "out": out, "calls": calls, "nets": nets}


def test_train_cli_builds_and_runs_the_fused_decoder(fused_cli):
    """`train --fused_decoder 1` builds a ShapeDecoderFused and runs it:
    per step 9 statistics passes (x5's once for its three stages), 11
    fused stages forward and 11 backward, plus the 11 forwards of the
    eval-mode debug dump at step 1."""
    assert len(fused_cli["nets"]) == 1
    assert isinstance(fused_cli["nets"][0].pop.decoder, ShapeDecoderFused)
    assert fused_cli["calls"] == {"column_stats": 9 * 3, "stage_fwd": 11 * 3 + 11,
                                  "stage_bwd": 11 * 3}


def test_fused_checkpoint_loads_with_either_decoder_and_in_jax(fused_cli):
    """The fused run's checkpoint evaluates through the reference decoder
    and back (float32: the two decoders' PSNR within 1e-3 dB), and
    scripts/convert_torch_checkpoint_jax.py carries it into JAX, which
    loads it with `--fused_decoder 0` as its cfg_args say."""
    import importlib
    import sys

    from gaussianavatar_tpu.config import Config as JConfig
    from gaussianavatar_tpu.engine.inference import load_trained as j_load_trained

    from gaussianavatar_torch import eval as eval_cli
    from gaussianavatar_torch.engine import checkpoint as tckpt

    out = fused_cli["out"]
    psnr = {f: eval_cli.main(["-m", out, "--fused_decoder", str(f)] + CPU)["frame_psnr"]
            for f in (0, 1)}
    np.testing.assert_allclose(psnr[0], psnr[1], rtol=0, atol=1e-3)

    sys.path.insert(0, join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "scripts"))
    importlib.import_module("convert_torch_checkpoint_jax").main(["-m", out])
    epoch = tckpt.latest_epoch(out)
    jcfg = JConfig.load(join(out, "cfg_args.json"))
    assert jcfg.net.fused_decoder == 1
    jcfg.net.fused_decoder = 0
    inf = j_load_trained(jcfg, epoch)
    net_sd = torch.load(join(tckpt.ckpt_dir(out, epoch), tckpt.CKPT_NAME), weights_only=True)
    j_sd = bridge.state_dict_from_jax(jax.tree.map(np.asarray, inf.state.params),
                                      jax.tree.map(np.asarray, inf.state.batch_stats))
    assert j_sd.keys() == net_sd.keys()
    for k, v in net_sd.items():
        assert torch.equal(j_sd[k], v), k


def test_train_multi_builds_the_fused_decoder_for_every_subject(tmp_path, monkeypatch):
    """`train_multi --fused_decoder 1`: every subject's network decodes
    through ShapeDecoderFused."""
    from gaussianavatar_torch import train_multi
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine import multi_loop

    srcs = []
    for name in ("a", "b"):
        srcs.append(str(tmp_path / name))
        write_synthetic_dataset(srcs[-1], n_train=2, n_test=1, image_size=32, device="cpu")
    built = []
    real = multi_loop.build_subjects

    def build(*a, **kw):
        res = real(*a, **kw)
        built.append(res)
        return res

    monkeypatch.setattr(multi_loop, "build_subjects", build)
    train_multi.main(["--sources", *srcs, "-m", str(tmp_path / "multi"), "--max_steps", "1",
                      "--fused_decoder", "1"] + SMALL_ARGS + CPU)
    subjects = built[0][0]
    assert len(subjects) == 2
    assert all(isinstance(s.bundle.net.pop.decoder, ShapeDecoderFused) for s in subjects)
