"""Port parity: the grid KNN, the host KNN and the AIAP loss (ops/knn), and
the local-frame transforms (ops/local_frames), against the JAX package on
the same numpy inputs.

Tolerances: neighbour indices equal wherever the true k-th and (k+1)-th
distances do not tie (to float noise); distances to 1e-6 (the same float32
sums); the AIAP value to 1e-6 and its gradient to 1e-5 of its largest
entry (sqrt near small distances lifts the summation-order noise); the
local frames to 1e-6 (elementwise float32 arithmetic and float32
einsums, HIGHEST precision on the JAX side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree
from scipy.spatial.transform import Rotation

from gaussianavatar_tpu.ops import knn as jknn
from gaussianavatar_tpu.ops import local_frames as jlf

from gaussianavatar_torch.ops import knn as tknn
from gaussianavatar_torch.ops import local_frames as tlf

torch.set_num_threads(2)


def test_grid_knn_matches_jax_and_host():
    """500 points in the unit cube, k 4, cell 0.25 >= the k-NN radius (the
    contract of tests/test_knn.py): against the JAX grid_knn and the exact
    host_knn."""
    pts = np.random.default_rng(0).uniform(size=(500, 3)).astype(np.float32)
    k = 4
    t_idx, t_d = tknn.grid_knn(torch.tensor(pts), k, cell_size=0.25, max_per_cell=32)
    j_idx, j_d = jknn.grid_knn(jnp.asarray(pts), k, cell_size=0.25, max_per_cell=32)
    assert t_idx.dtype == torch.int32 and t_idx.shape == (500, k)
    d_exact, i_exact = cKDTree(pts).query(pts, k=k + 2)
    # no tie between the k-th and (k+1)-th neighbour, nor inside the k
    gaps = np.diff(d_exact[:, 1:], axis=1)
    untied = (gaps > 1e-5).all(axis=1)
    assert untied.mean() > 0.95
    np.testing.assert_array_equal(t_idx.numpy()[untied], np.asarray(j_idx)[untied])
    np.testing.assert_array_equal(t_idx.numpy()[untied], tknn.host_knn(pts, k)[untied])
    np.testing.assert_array_equal(tknn.host_knn(pts, k), jknn.host_knn(pts, k))
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_d.numpy(), d_exact[:, 1:k + 1], rtol=0, atol=1e-6)
    assert (np.diff(t_d.numpy(), axis=1) >= 0).all() and (t_d.numpy() > 0).all()


def test_aiap_loss_matches_jax():
    """Value and gradient (w.r.t. both point sets) of a non-rigid
    deformation; zero, to float noise, for a rigid motion."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(2, 200, 3)).astype(np.float32)
    nn = tknn.host_knn(pts[0], 5)
    moved = (pts * np.array([1.3, 1.0, 0.8], np.float32)
             + rng.normal(scale=0.05, size=pts.shape)).astype(np.float32)

    j_val, (j_gc, j_gd) = jax.value_and_grad(jknn.aiap_loss, argnums=(0, 1))(
        jnp.asarray(pts[:1]), jnp.asarray(moved), jnp.asarray(nn))
    tc = torch.tensor(pts[:1], requires_grad=True)
    td = torch.tensor(moved, requires_grad=True)
    t_val = tknn.aiap_loss(tc, td, torch.tensor(nn))
    t_val.backward()
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=0, atol=1e-6)
    for t, j in ((tc.grad, j_gc), (td.grad, j_gd)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max())

    R = Rotation.random(random_state=2).as_matrix().astype(np.float32)
    rigid = pts[0] @ R.T + np.array([0.3, -0.1, 2.0], np.float32)
    assert float(tknn.aiap_loss(torch.tensor(pts[0]), torch.tensor(rigid),
                                torch.tensor(nn))) < 1e-5


@pytest.fixture(scope="module")
def uv_grid():
    rng = np.random.default_rng(3)
    V, R, Jn = 30, 6, 5
    faces = rng.integers(0, V, size=(R, R, 3)).astype(np.int32)
    bary = rng.uniform(size=(R, R, 3)).astype(np.float32)
    bary /= bary.sum(-1, keepdims=True)
    return rng, V, faces, bary, Jn


def test_full_uv_frames_match_jax(uv_grid):
    rng, V, faces, _, _ = uv_grid
    verts = rng.normal(size=(2, V, 3)).astype(np.float32)
    out = tlf.gen_transf_mtx_full_uv(torch.tensor(verts), torch.tensor(faces))
    ref = np.asarray(jlf.gen_transf_mtx_full_uv(jnp.asarray(verts), jnp.asarray(faces)))
    assert out.shape == ref.shape == (2, 6, 6, 3, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_vtransf_and_lbs_interpolation_match_jax(uv_grid):
    rng, V, faces, bary, Jn = uv_grid
    vtransf = rng.normal(size=(2, V, 3, 3)).astype(np.float32)
    out = tlf.gen_transf_mtx_from_vtransf(torch.tensor(vtransf), torch.tensor(bary),
                                          torch.tensor(faces), scaling=2.0)
    ref = np.asarray(jlf.gen_transf_mtx_from_vtransf(jnp.asarray(vtransf), jnp.asarray(bary),
                                                     jnp.asarray(faces), scaling=2.0))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)

    w = rng.uniform(size=(V, Jn)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    out = tlf.gen_lbs_weight_from_ori(torch.tensor(w), torch.tensor(bary), torch.tensor(faces))
    ref = np.asarray(jlf.gen_lbs_weight_from_ori(jnp.asarray(w), jnp.asarray(bary),
                                                 jnp.asarray(faces)))
    assert out.shape == (6, 6, Jn)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
