"""Port parity of the JAX package's library functions that no training path
calls, and of its training log's TensorBoard mirror and stdout shim, each
against the JAX function on the same numpy inputs from a seed.

Tolerances (absolute, on outputs of order 1 unless stated): rotations 1e-6
(the same float32 formulas; 2e-6 where a matrix product or an atan2 sits
between), the quaternion route to axis-angle 1e-5 (angles near pi divide by
a small sine), `normalize`, `l2_loss` and `compute_cov3d` 1e-6 relative to
the largest |value|, `grid_sample` 1e-6 (bilinear weights of the same pixel
math), the camera helpers and the body loader exact (the same numpy or the
same file)."""

import importlib
import os
import re
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _rotations(rng, n):
    """n rotation matrices (float32) from random unit quaternions, with the
    identity and rotations of angle near pi about each axis (each pivot of
    matrix_to_quaternion wins somewhere)."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)
    a = 3.1
    c, s = np.cos(a), np.sin(a)
    extra = [np.eye(3),
             [[1, 0, 0], [0, c, -s], [0, s, c]],
             [[c, 0, s], [0, 1, 0], [-s, 0, c]],
             [[c, -s, 0], [s, c, 0], [0, 0, 1]]]
    return np.concatenate([R, np.asarray(extra)]).astype(np.float32)


def _case_euler(rng):
    from gaussianavatar_tpu.ops import rotations as jr

    from gaussianavatar_torch.ops import rotations as tr

    angles = rng.uniform(-np.pi, np.pi, size=(5, 4, 3)).astype(np.float32)
    outs = [(tr.euler_angles_to_matrix(torch.as_tensor(angles), conv).numpy(),
             np.asarray(jr.euler_angles_to_matrix(jnp.asarray(angles), conv)))
            for conv in ("XYZ", "ZYX", "YXZ")]
    return [t for t, _ in outs], [j for _, j in outs], 2e-6


def _case_matrix_to_quaternion(rng):
    from gaussianavatar_tpu.ops import rotations as jr

    from gaussianavatar_torch.ops import rotations as tr

    R = _rotations(rng, 64)
    return (tr.matrix_to_quaternion(torch.as_tensor(R)).numpy(),
            np.asarray(jr.matrix_to_quaternion(jnp.asarray(R))), 1e-6)


def _case_matrix_to_axis_angle(rng):
    from gaussianavatar_tpu.ops import rotations as jr

    from gaussianavatar_torch.ops import rotations as tr

    R = _rotations(rng, 64)
    return (tr.matrix_to_axis_angle(torch.as_tensor(R)).numpy(),
            np.asarray(jr.matrix_to_axis_angle(jnp.asarray(R))), 1e-5)


def _case_quaternion_to_axis_angle(rng):
    from gaussianavatar_tpu.ops import rotations as jr

    from gaussianavatar_torch.ops import rotations as tr

    q = rng.normal(size=(64, 4))
    q[:4, 1:] *= 1e-9  # below eps: the small-angle branch
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q = q.astype(np.float32)
    return (tr.quaternion_to_axis_angle(torch.as_tensor(q)).numpy(),
            np.asarray(jr.quaternion_to_axis_angle(jnp.asarray(q))), 2e-6)


def _case_normalize(rng):
    from gaussianavatar_tpu.ops import rotations as jr

    from gaussianavatar_torch.ops import rotations as tr

    v = rng.normal(size=(6, 5, 3)).astype(np.float32)
    v[0, 0] = 0.0  # below eps: divided by eps, as F.normalize
    outs = [(tr.normalize(torch.as_tensor(v), axis=ax).numpy(),
             np.asarray(jr.normalize(jnp.asarray(v), axis=ax))) for ax in (-1, 1)]
    return [t for t, _ in outs], [j for _, j in outs], 1e-6


def _case_camera(rng):
    from gaussianavatar_tpu.ops import camera as jc

    from gaussianavatar_torch.ops import camera as tc

    fov = rng.uniform(0.3, 1.5, size=4)
    t = [np.asarray([tc.fov2focal(f, 512) for f in fov])]
    j = [np.asarray([jc.fov2focal(f, 512) for f in fov])]
    for fx, fy in zip(fov[:2], fov[2:]):
        t.append(tc.projection_from_fov(0.01, 100.0, fx, fy))
        j.append(jc.projection_from_fov(0.01, 100.0, fx, fy))
    return t, j, 0.0


def _case_compute_cov3d(rng):
    from gaussianavatar_tpu.ops import projection as jp

    from gaussianavatar_torch.ops import projection as tp

    scales = rng.uniform(1e-3, 0.1, size=(128, 3)).astype(np.float32)
    quats = rng.normal(size=(128, 4)).astype(np.float32)
    j = np.asarray(jp.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats), 1.5))
    t = tp.compute_cov3d(torch.as_tensor(scales), torch.as_tensor(quats), 1.5).numpy()
    return t, j, 1e-6 * np.abs(j).max()


def _case_l2_loss(rng):
    # the JAX ops package exports the function ssim under the module's name
    js = importlib.import_module("gaussianavatar_tpu.ops.ssim")
    ts = importlib.import_module("gaussianavatar_torch.ops.ssim")

    a, b = rng.uniform(size=(2, 2, 3, 32, 32)).astype(np.float32)
    j = np.asarray(js.l2_loss(jnp.asarray(a), jnp.asarray(b)))
    return ts.l2_loss(torch.as_tensor(a), torch.as_tensor(b)).numpy(), j, 1e-6 * abs(float(j))


def _case_grid_sample(rng):
    from gaussianavatar_tpu.ops import resample as jrs

    from gaussianavatar_torch.ops import resample as trs

    feat = rng.normal(size=(2, 9, 7, 5)).astype(np.float32)      # NHWC
    grid = rng.uniform(-1.2, 1.2, size=(2, 6, 11, 2)).astype(np.float32)  # some outside
    j = np.asarray(jrs.grid_sample(jnp.asarray(feat), jnp.asarray(grid)))
    t = trs.grid_sample(torch.as_tensor(feat.transpose(0, 3, 1, 2)), torch.as_tensor(grid))
    return t.numpy().transpose(0, 2, 3, 1), j, 1e-6


def _case_body_create(rng, tmp_path):
    from gaussianavatar_tpu.models import body as jb

    from gaussianavatar_torch.models import body as tb

    J, V = 24, 40
    f32 = lambda a: np.asarray(a, np.float32)
    parents = np.concatenate([[0], np.arange(J - 1)])  # a chain; [0] is rewritten as -1
    np.savez(tmp_path / "SMPL_NEUTRAL.npz",
             v_template=f32(rng.normal(size=(V, 3))),
             shapedirs=f32(rng.normal(scale=0.01, size=(V, 3, 10))),
             posedirs=f32(rng.normal(scale=0.01, size=(V, 3, 9 * (J - 1)))),
             J_regressor=f32(np.ones((J, V)) / V), weights=f32(np.ones((V, J)) / J),
             kintree_table=np.stack([parents, np.arange(J)]), f=np.zeros((1, 3), np.int64))
    jm = jb.create(str(tmp_path), "smpl", "neutral", num_betas=10)
    tm = tb.create(str(tmp_path), "smpl", "neutral", num_betas=10)
    names = ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights", "parents",
             "faces")
    t = [np.asarray(getattr(tm, n)) for n in names]
    j = [np.asarray(getattr(jm, n)) for n in names]
    pose = rng.normal(scale=0.3, size=(2, 3 + 3 * (J - 1))).astype(np.float32)
    betas = rng.normal(size=(2, 10)).astype(np.float32)
    t.append(tb.forward(tm, torch.as_tensor(betas), torch.as_tensor(pose[:, :3]),
                        torch.as_tensor(pose[:, 3:])).vertices.numpy())
    j.append(np.asarray(jb.forward(jm, jnp.asarray(betas), jnp.asarray(pose[:, :3]),
                                   jnp.asarray(pose[:, 3:])).vertices))
    # the files load to the same arrays; the posed vertices as the body-family test
    return t, j, [0.0] * len(names) + [1e-6 * max(1.0, np.abs(j[-1]).max())]


CASES = {
    "euler_angles_to_matrix": _case_euler,
    "matrix_to_quaternion": _case_matrix_to_quaternion,
    "matrix_to_axis_angle": _case_matrix_to_axis_angle,
    "quaternion_to_axis_angle": _case_quaternion_to_axis_angle,
    "normalize": _case_normalize,
    "fov2focal-projection_from_fov": _case_camera,
    "compute_cov3d": _case_compute_cov3d,
    "l2_loss": _case_l2_loss,
    "grid_sample": _case_grid_sample,
    "body.create": _case_body_create,
}


@pytest.mark.parametrize("name", list(CASES))
def test_library_function_matches_jax(name, tmp_path):
    rng = np.random.default_rng(list(CASES).index(name))
    fn = CASES[name]
    t, j, tol = fn(rng, tmp_path) if name == "body.create" else fn(rng)
    t, j = (t, j) if isinstance(t, list) else ([t], [j])
    tols = tol if isinstance(tol, list) else [tol] * len(t)
    for i, (a, b, tl) in enumerate(zip(t, j, tols)):
        assert np.shape(a) == np.shape(b), (name, i)
        np.testing.assert_allclose(a, b, rtol=0, atol=tl, err_msg=f"{name} [{i}]")


class _Writer:
    """A stand-in SummaryWriter: records what each logger mirrors."""

    made = []

    def __init__(self, log_dir):
        self.log_dir, self.scalars, self.closed = log_dir, [], False
        _Writer.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        self.closed = True


@pytest.mark.parametrize("tensorboard", ["present", "missing"])
def test_tensorboard_mirror_matches_jax(tensorboard, tmp_path, monkeypatch):
    """With `torch.utils.tensorboard` importable, each logger makes one
    writer on its model path and mirrors every scalar as
    train_loss_patches/<name> at its step, the port as JAX; with the import
    failing neither mirrors and both still write metrics.jsonl."""
    from gaussianavatar_tpu.engine.logging_utils import MetricsLogger as JLogger

    from gaussianavatar_torch.engine.logging_utils import MetricsLogger as TLogger

    module = None
    if tensorboard == "present":
        module = types.ModuleType("torch.utils.tensorboard")
        module.SummaryWriter = _Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", module)
    _Writer.made = []
    records = [(1, {"l1": 0.5, "ssim": 0.25}), (10, {"l1": 0.125, "total": np.float32(0.75)})]
    loggers = {}
    for side, cls in (("jax", JLogger), ("port", TLogger)):
        logger = cls(str(tmp_path / side))
        for step, scalars in records:
            logger.log(step, scalars)
        logger.log_event("lpips", "disabled")
        logger.close()
        loggers[side] = logger
        assert sum(1 for _ in open(tmp_path / side / "metrics.jsonl")) == 3
    if tensorboard == "missing":
        assert loggers["jax"].tb is None and loggers["port"].tb is None and not _Writer.made
        return
    jw, tw = _Writer.made
    assert (jw.log_dir, tw.log_dir) == (str(tmp_path / "jax"), str(tmp_path / "port"))
    assert tw.scalars == jw.scalars
    assert [s[0] for s in tw.scalars] == ["train_loss_patches/l1", "train_loss_patches/ssim",
                                          "train_loss_patches/l1", "train_loss_patches/total"]
    assert jw.closed and tw.closed


def test_safe_state_matches_jax(capsys, monkeypatch):
    """safe_state: every line ends with the same ' [dd/mm HH:MM:SS]' stamp
    as the JAX shim's, a write without a newline passes as it is, quiet
    writes nothing, and Python's and numpy's generators draw as after JAX's
    seeding; the port's training CLIs put the stream back when they return,
    also when the run raises."""
    import random

    from gaussianavatar_tpu.engine import logging_utils as jlog

    from gaussianavatar_torch.engine import logging_utils as tlog

    out, draws = {}, {}
    for side, mod in (("jax", jlog), ("port", tlog)):
        before = sys.stdout
        capsys.readouterr()
        mod.safe_state(False, seed=5)
        draws[side] = (random.random(), np.random.random())
        print("one\ntwo")
        sys.stdout.write("partial")
        sys.stdout.flush()
        sys.stdout = before
        out[side] = capsys.readouterr().out
        mod.safe_state(True)
        print("hidden")
        sys.stdout = before
        assert capsys.readouterr().out == ""
    assert draws["port"] == draws["jax"]
    strip = lambda s: [line[:line.rindex(" [")] if line.endswith("]") else line
                       for line in s.split("\n")]
    assert strip(out["port"]) == strip(out["jax"]) == ["one", "two", "partial"]
    # print writes its text and its newline apart: the newline takes the stamp
    assert re.fullmatch(r"two \[\d\d/\d\d \d\d:\d\d:\d\d\]", out["port"].split("\n")[1])

    seen = []
    for cli in ("train", "train_multi"):
        mod = importlib.import_module(f"gaussianavatar_torch.{cli}")

        def run(*args, _cli=cli):
            seen.append((_cli, type(sys.stdout).__name__))
            raise RuntimeError("stop")

        monkeypatch.setattr(mod, "run_training", run)
        before = sys.stdout
        argv = ["-s", os.getcwd(), "-m", os.getcwd(), "--device", "cpu"]
        if cli == "train_multi":
            argv = ["--sources", os.getcwd(), "-m", os.getcwd(), "--device", "cpu", "--quiet"]
        with pytest.raises(RuntimeError, match="stop"):
            mod.main(argv)
        assert sys.stdout is before, cli
    assert seen == [("train", "_TimestampedStdout"), ("train_multi", "_TimestampedStdout")]
