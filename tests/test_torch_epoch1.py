"""Port parity, the first steps of a campaign from flax's initial network
with the need table (ROADMAP F20): what `tests/test_torch_train.py` leaves
out, held against the JAX package at a small size on one set of weights.

Both packages start from one JAX `init_state` (the port through
bridge.py), in scripts/torch_jax_epoch1.py's harness (`JaxRun`, `PortRun`):
the f32 decoder, footprint M=9, the JAX f32 probe's caps fed to every step,
and training from iteration 0, so the scale warm-up's first factors
(1e-3, 2e-3, 3e-3) shape the gaussians.

1. The capped step, anchored: at each of three steps, the port's step from
   JAX's own state against JAX's (loss terms, the raster overflow, every
   gradient, the BatchNorm running statistics after the step).
2. The eval-mode decode the need table's probe and the gates read, on JAX's
   state after those steps (running statistics that moved three times).
3. The port's probe on that state against JAX's probe on it.
4. The initial network the train CLIs draw at `--init flax`: JAX's
   `init_state(PRNGKey(0))` itself (F20's repair, models/init.py).

Tolerances are stated where they are asserted."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))

import torch_jax_epoch1 as harness  # noqa: E402

torch.set_num_threads(2)

BATCHES = ([0, 1], [2, 3], [1, 2])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset

    tmp = tmp_path_factory.mktemp("epoch1")
    data = str(tmp / "data")
    write_synthetic_dataset(data, n_train=4, n_test=1, image_size=64, device="cpu")
    a = SimpleNamespace(work=str(tmp), image=64, tile=16, query=64, inp=32, hsize=16,
                        c_geom=8)
    jax_run = harness.JaxRun(a, data, bf16=0)
    raw, _ = jax_run.probe()
    caps = np.minimum(np.ceil(raw * jax_run.margin), jax_run.capacity).astype(np.int32)
    jax_run.set_caps(caps)
    params, stats = jax_run.trees()
    port = harness.PortRun(a, data, params, stats)
    port.caps.copy_(torch.as_tensor(caps))
    w_rgl, gate = 10.0, 0.0
    steps = []
    for s, idxs in enumerate(BATCHES, start=1):
        before = jax_run.state_dict()
        j_grad = jax_run.gradients(idxs, w_rgl, gate)
        port.load(before, s - 1)
        t_terms, _ = port.step(idxs, w_rgl, gate)
        t_grad = {n: p.grad.clone() for n, p in port.net.named_parameters() if p.grad is not None}
        t_stats = {k: v.clone() for k, v in port.net.state_dict().items() if "running" in k}
        j_terms, _ = jax_run.step(idxs, w_rgl, gate)
        steps.append({"t_terms": t_terms, "j_terms": j_terms, "t_grad": t_grad,
                      "j_grad": j_grad, "t_stats": t_stats, "j_after": jax_run.state_dict()})
    params, stats = jax_run.trees()
    port.load(jax_run.state_dict(), len(BATCHES))
    return {"steps": steps, "jax": jax_run, "port": port, "params": params, "stats": stats,
            "caps": caps}


@pytest.mark.parametrize("step", [1, 2, 3])
def test_capped_step_matches_jax(runs, step):
    """From JAX's state: loss terms to 1e-5 relative; the raster overflow
    (pairs the footprint and the caps left out) to 1e-3 relative (an ulp of
    LBS can move a gaussian's tile rect); gradients to 2e-4 of each leaf's
    largest |gradient| (float noise through LBS, binning and the blend), the
    BatchNorm-absorbed Dense biases left out (their true gradient is 0);
    running statistics after the step to 1e-5 of each one's largest."""
    rec = runs["steps"][step - 1]
    assert rec["j_terms"]["raster_overflow"] > 0   # the caps cut pairs
    for k in harness.TERMS:
        tol = 1e-3 if k == "raster_overflow" else 1e-5
        np.testing.assert_allclose(rec["t_terms"][k], rec["j_terms"][k], rtol=tol, err_msg=k)
    for name, g in rec["t_grad"].items():
        if harness.absorbed(name):
            continue
        j = rec["j_grad"][name].numpy()
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=2e-4 * np.abs(j).max(),
                                   err_msg=name)
    for name, v in rec["t_stats"].items():
        j = rec["j_after"][name].numpy()
        np.testing.assert_allclose(v.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max(),
                                   err_msg=name)


def test_eval_decode_after_steps_matches_jax(runs):
    """The eval-mode decode (running statistics, the inference iteration) on
    JAX's state after three steps: the scales to 1e-5 of their largest, and
    the statistics differ from the initial ones, so the eval path reads
    moved statistics."""
    j = runs["jax"].decode_scales(False)
    t = runs["port"].decode_scales(False)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())
    moved = [float(np.abs(v - (0.0 if "mean" in k else 1.0)).max())
             for k, v in runs["port"].bn_stats().items()]
    assert min(moved) > 1e-3


def test_probe_on_trained_state_matches_jax(runs):
    """The port's probe (NeedTable) on JAX's state after three steps against
    the JAX loop's `make_counts_fn` there: the needed depth equals JAX's on
    at least 97% of the (frame, tile) cells and moves by at most 4 ranks
    where not (an ulp of LBS, tests/test_torch_need_table.py); the clipped
    and all pairs at M=4 within 0.5%."""
    j_raw, j_clip = runs["jax"].probe()
    t_raw, t_clip = runs["port"].probe_state(runs["params"], runs["stats"])
    d = np.abs(t_raw - j_raw)
    assert (d == 0).mean() >= 0.97 and d.max() <= 4, (d.max(), (d == 0).mean())
    assert j_raw.max() > 0 and j_clip[1] > 0
    np.testing.assert_allclose(t_clip, j_clip, rtol=5e-3)


def test_cli_init_is_jax_init_state(tmp_path):
    """The train CLIs' `--init flax` network (engine/setup.setup_avatar,
    seed 0) is JAX's `init_state` with its default PRNGKey(0), leaf for
    leaf to 1e-5 of each leaf's largest |value| (the inverse error function
    in float64 against XLA's float32, tests/test_torch_init.py), so the
    decoder's first scales are JAX's: their mean, which set F20's regime
    (0.51 from JAX's draw, 0.76 from the draw the port made before, at the
    canonical widths), to 1e-5."""
    from gaussianavatar_torch import bridge
    from gaussianavatar_torch.config import build_parser, extract_config
    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_torch.engine.setup import setup_avatar

    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_train=4, n_test=1, image_size=64, device="cpu")
    a = SimpleNamespace(work=str(tmp_path), image=64, tile=16, query=64, inp=32, hsize=16,
                        c_geom=8)
    params, stats = harness.JaxRun(a, data, bf16=0).trees()
    cfg = extract_config(build_parser().parse_args(harness.cli_flags(a, data, 0)))
    bundle = setup_avatar(cfg, device="cpu", train=True, init="flax")
    jax_sd = bridge.state_dict_from_jax(params, stats)
    port_sd = bundle.net.state_dict()
    assert port_sd.keys() == jax_sd.keys()
    for k, j in jax_sd.items():
        np.testing.assert_allclose(port_sd[k].numpy(), j.numpy(), rtol=0,
                                   atol=1e-5 * max(float(j.abs().max()), 1e-30), err_msg=k)
    bundle.net.train()
    with torch.no_grad():
        t_mean = float(bundle.net.decode(bundle.assets, 1)[1].mean())
        bundle.net.load_state_dict(jax_sd)
        j_mean = float(bundle.net.decode(bundle.assets, 1)[1].mean())
    np.testing.assert_allclose(t_mean, j_mean, rtol=1e-5)
