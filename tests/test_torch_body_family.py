"""Port parity, the rest of the body-model family (models/body.py): SMPL-H,
MANO and FLAME pose assembly, the expression blendshapes and the loader's
split of the expression columns, each against the JAX package's
models/body.py on the same tiny synthetic models (tests/test_body.py's
`_tiny_model`: J = 52, 16, 5, and 55 with expressions) and random poses.
Vertices, joints and A within 1e-6 of each one's largest |value| (or 1e-6
where that is below 1): the same f32 LBS, summed in another order, a few
ulps apart on unit-sized outputs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.models import body as jbody

from gaussianavatar_torch.models import body as tbody

torch.set_num_threads(2)

TOL = 1e-6


def _tiny_arrays(J, V=40, seed=1, n_expr=0):
    """tests/test_body.py's tiny model, with random posedirs so that the pose
    blendshapes count too."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        v_template=f32(rng.normal(size=(V, 3))),
        shapedirs=f32(rng.normal(scale=0.01, size=(V, 3, 10))),
        posedirs=f32(rng.normal(scale=0.01, size=(9 * (J - 1), V * 3))),
        J_regressor=f32(np.ones((J, V)) / V),
        lbs_weights=f32(np.ones((V, J)) / J),
        parents=np.concatenate([[-1], np.zeros(J - 1, int)]).astype(np.int32),
        faces=np.zeros((1, 3), np.int64),
        expr_dirs=f32(rng.normal(scale=0.01, size=(V, 3, n_expr))) if n_expr else None,
    )


def _models(J, model_type, n_expr=0):
    a = _tiny_arrays(J, n_expr=n_expr)
    jm = jbody.BodyModel(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) and k not in
                               ("parents", "faces") else v) for k, v in a.items()},
                         model_type=model_type)
    tm = tbody.BodyModel(**{k: (torch.as_tensor(v) if isinstance(v, np.ndarray) and k not in
                               ("parents", "faces") else v) for k, v in a.items()},
                         model_type=model_type)
    return jm, tm


def _same(t_out, j_out):
    for name in ("vertices", "joints", "A"):
        t, j = getattr(t_out, name).numpy(), np.asarray(getattr(j_out, name))
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL * max(1.0, np.abs(j).max()),
                                   err_msg=name)


def _pose(rng, B, n):
    return rng.normal(scale=0.3, size=(B, n)).astype(np.float32)


# (model type, J, the forward's pose arguments: name -> width)
CASES = {
    "smplh": (52, {"body_pose": 63, "left_hand_pose": 45, "right_hand_pose": 45}),
    "smplh-no-right-hand": (52, {"body_pose": 63, "left_hand_pose": 45}),
    "mano": (16, {"body_pose": 45}),
    "mano-right-hand": (16, {"body_pose": None, "right_hand_pose": 45}),
    "mano-left-hand": (16, {"body_pose": None, "left_hand_pose": 45}),
    "flame": (5, {"body_pose": None, "neck_pose": 3, "jaw_pose": 3, "leye_pose": 3,
                  "reye_pose": 3}),
    "flame-jaw-only": (5, {"body_pose": None, "jaw_pose": 3}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pose_assembly_matches_jax(case):
    """Each variant assembles its full pose as the JAX forward does (the
    parts not given are zero): A is (B, J, 4, 4) and vertices, joints and A
    agree, with a translation folded in."""
    model_type = case.split("-")[0]
    J, widths = CASES[case]
    jm, tm = _models(J, model_type)
    rng = np.random.default_rng(sorted(CASES).index(case))
    B = 2
    betas, glob, transl = _pose(rng, B, 10), _pose(rng, B, 3), _pose(rng, B, 3)
    kw = {k: (None if n is None else _pose(rng, B, n)) for k, n in widths.items()}
    j_out = jbody.forward(jm, jnp.asarray(betas), jnp.asarray(glob), transl=jnp.asarray(transl),
                          **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    t_out = tbody.forward(tm, torch.as_tensor(betas), torch.as_tensor(glob),
                          transl=torch.as_tensor(transl),
                          **{k: None if v is None else torch.as_tensor(v) for k, v in kw.items()})
    assert t_out.A.shape == (B, J, 4, 4)
    _same(t_out, j_out)


def test_pose_assembly_rejects_wrong_width():
    _, tm = _models(52, "smplh")
    z = lambda n: torch.zeros(1, n)
    with pytest.raises(ValueError, match="full pose has"):
        tbody.forward(tm, z(10), z(3), body_pose=z(69))


def test_expression_blendshapes_match_jax():
    """SMPL-X with 10 expression coefficients: the displacement is expr_dirs
    @ expression over the rest shape, and the posed outputs agree with the
    JAX forward."""
    jm, tm = _models(55, "smplx", n_expr=10)
    rng = np.random.default_rng(4)
    B = 2
    betas, glob = _pose(rng, B, 10), _pose(rng, B, 3)
    body = _pose(rng, B, 63)
    expr = np.stack([np.linspace(-1, 1, 10), np.linspace(1, -1, 10)]).astype(np.float32)
    t = lambda a: torch.as_tensor(a)
    rest = tbody.forward(tm, t(betas), t(glob) * 0, t(body) * 0)
    out0 = tbody.forward(tm, t(betas), t(glob) * 0, t(body) * 0, expression=t(expr))
    expected = rest.vertices.numpy() + np.einsum("vde,be->bvd", tm.expr_dirs.numpy(), expr)
    np.testing.assert_allclose(out0.vertices.numpy(), expected, rtol=0,
                               atol=TOL * max(1.0, np.abs(expected).max()))

    t_out = tbody.forward(tm, t(betas), t(glob), t(body), expression=t(expr))
    j_out = jbody.forward(jm, jnp.asarray(betas), jnp.asarray(glob), jnp.asarray(body),
                          expression=jnp.asarray(expr))
    _same(t_out, j_out)


def test_expression_without_expr_dirs_is_rejected():
    """Both packages refuse an expression for a model without its
    blendshapes."""
    jm, tm = _models(55, "smplx")
    expr = np.zeros((1, 10), np.float32)
    with pytest.raises(ValueError, match="no expression blendshapes"):
        tbody.forward(tm, torch.zeros(1, 10), torch.zeros(1, 3), torch.zeros(1, 63),
                      expression=torch.as_tensor(expr))
    with pytest.raises(ValueError, match="no expression blendshapes"):
        jbody.forward(jm, jnp.zeros((1, 10)), jnp.zeros((1, 3)), jnp.zeros((1, 63)),
                      expression=jnp.asarray(expr))


def _model_file(tmp_path, name, J, n_shape_cols, V=30, seed=2):
    rng = np.random.default_rng(seed)
    data = {
        "v_template": rng.normal(size=(V, 3)),
        "shapedirs": rng.normal(size=(V, 3, n_shape_cols)),
        "posedirs": rng.normal(size=(V, 3, 9 * (J - 1))),
        "J_regressor": rng.uniform(size=(J, V)),
        "kintree_table": np.stack(
            [np.concatenate([[2**32 - 1], np.zeros(J - 1, np.int64)]), np.arange(J)]),
        "weights": (lambda w: w / w.sum(1, keepdims=True))(rng.uniform(size=(V, J))),
        "f": rng.integers(0, V, size=(50, 3)),
    }
    np.savez(os.path.join(tmp_path, name), **data)
    return data


@pytest.mark.parametrize("model_type,name,J,cols,start", [
    ("smplx", "SMPLX_NEUTRAL.npz", 55, 400, 300),   # the full 300 + 100 space
    ("smplx", "SMPLX_NEUTRAL.npz", 55, 20, 10),     # a compact file
    ("flame", "FLAME_NEUTRAL.npz", 5, 400, 300),
])
def test_loader_splits_expression_dirs(tmp_path, model_type, name, J, cols, start):
    """A file with 400 or more shapedir columns holds the expressions at
    column 300, a compact one at 10: both loaders slice the same expr_dirs,
    shapedirs and posedirs, and pose the loaded model alike."""
    data = _model_file(tmp_path, name, J, cols)
    jm = jbody.load_body_model(str(tmp_path), model_type, "neutral", num_betas=10,
                               num_expressions=10)
    tm = tbody.load_body_model(str(tmp_path), model_type, "neutral", num_betas=10,
                               num_expressions=10)
    assert tm.shapedirs.shape == (30, 3, 10) and tm.expr_dirs.shape == (30, 3, 10)
    np.testing.assert_allclose(tm.expr_dirs.numpy(), data["shapedirs"][:, :, start:start + 10],
                               rtol=0, atol=1e-6)
    for field in ("v_template", "shapedirs", "expr_dirs", "posedirs", "J_regressor",
                  "lbs_weights"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(),
                                      np.asarray(getattr(jm, field)), err_msg=field)
    np.testing.assert_array_equal(tm.parents, jm.parents)
    rng = np.random.default_rng(5)
    args = [_pose(rng, 1, 10), _pose(rng, 1, 3),
            None if model_type == "flame" else _pose(rng, 1, 63)]
    expr = _pose(rng, 1, 10)
    t_out = tbody.forward(tm, *[None if a is None else torch.as_tensor(a) for a in args],
                          expression=torch.as_tensor(expr))
    j_out = jbody.forward(jm, *[None if a is None else jnp.asarray(a) for a in args],
                          expression=jnp.asarray(expr))
    _same(t_out, j_out)


def test_loader_finds_mano_and_counts_joints(tmp_path):
    """A directory holding MANO_RIGHT.pkl loads as mano with either
    package's search; NUM_JOINTS is the JAX package's table."""
    import pickle

    data = _model_file(tmp_path, "unused.npz", 16, 10)
    with open(tmp_path / "MANO_RIGHT.pkl", "wb") as f:
        pickle.dump(data, f)
    tm = tbody.load_body_model(str(tmp_path), "mano", "right", num_betas=10)
    jm = jbody.load_body_model(str(tmp_path), "mano", "right", num_betas=10)
    assert tm.model_type == "mano" and tm.expr_dirs is None and jm.expr_dirs is None
    np.testing.assert_array_equal(tm.v_template.numpy(), np.asarray(jm.v_template))
    assert tbody.NUM_JOINTS == jbody.NUM_JOINTS
    assert tbody.NUM_JOINTS["mano"] == tm.parents.shape[0]
