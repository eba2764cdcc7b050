"""Port parity, geometry: rotations, LBS / body.forward on the synthetic body,
camera matrices, avatar assets and pose_gaussians. The same numpy inputs go
through gaussianavatar_tpu (JAX, CPU) and gaussianavatar_torch (CPU).
All float32; tolerances are a few ulps of the values compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.models import body as jbody
from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.models.avatar import pose_gaussians as j_pose_gaussians
from gaussianavatar_tpu.ops import rotations as jrot
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body

from gaussianavatar_torch.models import body as tbody
from gaussianavatar_torch.models.avatar import build_avatar_assets as t_build_assets
from gaussianavatar_torch.models.avatar import pose_gaussians as t_pose_gaussians
from gaussianavatar_torch.ops import rotations as trot
from gaussianavatar_torch.ops.camera import Camera as TCamera
from gaussianavatar_torch.utils.synthetic import synthetic_body as t_synthetic_body

torch.set_num_threads(2)

# f32 geometry: values of order 1, a few ulps of accumulated rounding
ATOL = 2e-6


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    aa = rng.normal(scale=1.2, size=(64, 3)).astype(np.float32)
    aa[0] = 0.0  # the eps-regularised zero rotation
    np.testing.assert_allclose(
        _np(trot.axis_angle_to_matrix(torch.as_tensor(aa))),
        np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa))), atol=ATOL)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        _np(trot.quaternion_to_matrix(torch.as_tensor(q))),
        np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q))), atol=ATOL)


def test_synthetic_body_arrays_identical():
    jm, juv = j_synthetic_body(n_rings=12, n_cols=8)
    tm, tuv = t_synthetic_body(n_rings=12, n_cols=8)
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
        np.testing.assert_array_equal(_np(getattr(tm, name)), np.asarray(getattr(jm, name)), name)
    np.testing.assert_array_equal(tm.parents, jm.parents)
    for a, b in zip(tuv, juv):
        np.testing.assert_array_equal(a, b)


def _body_variant(variant, tmp_path):
    """(JAX model, port model, J, the forward's extra smplx kwargs as numpy)."""
    rng = np.random.default_rng(3)
    if variant == "smplx":  # 55 joints: body 21 + jaw + eyes + 2 x 15 hand joints
        jm, _ = j_synthetic_body(n_joints=55)
        tm, _ = t_synthetic_body(n_joints=55)
        jm, tm = jm._replace(model_type="smplx"), tm._replace(model_type="smplx")
        widths = {"jaw_pose": 3, "leye_pose": 3, "reye_pose": 3,
                  "left_hand_pose": 45, "right_hand_pose": 45}
        return jm, tm, 55, {k: rng.normal(scale=0.2, size=(3, n)).astype(np.float32)
                            for k, n in widths.items()}
    jm, _ = j_synthetic_body()
    if variant == "keypoints":  # vertex-anchored extra joints (official meshes)
        ids = np.array([3, 50, 99, 200], np.int32)
        tm, _ = t_synthetic_body()
        return jm._replace(extra_joint_ids=ids), tm._replace(extra_joint_ids=ids), 5, {}
    # "npz_loader": both packages read the same official-layout model file
    V = jm.v_template.shape[0]
    path = str(tmp_path / "SMPL_NEUTRAL.npz")
    np.savez(path, v_template=np.asarray(jm.v_template), shapedirs=np.asarray(jm.shapedirs),
             posedirs=np.asarray(jm.posedirs).T.reshape(V, 3, -1),
             J_regressor=np.asarray(jm.J_regressor),
             kintree_table=np.stack([np.asarray(jm.parents), np.arange(5)]),
             weights=np.asarray(jm.lbs_weights), f=jm.faces)
    return (jbody.load_body_model(str(tmp_path), num_betas=4),
            tbody.load_body_model(str(tmp_path), num_betas=4), 5, {})


@pytest.mark.parametrize("variant", ["smpl_npz_loader", "smplx", "keypoints"])
def test_body_forward_matches_jax(variant, tmp_path):
    jm, tm, J, extra = _body_variant(variant.replace("smpl_", ""), tmp_path)
    rng = np.random.default_rng(1)
    B = 3
    pose = rng.normal(scale=0.4, size=(B, 3 + (63 if variant == "smplx" else (J - 1) * 3)))
    pose = pose.astype(np.float32)
    betas = rng.normal(scale=0.5, size=(B, 4)).astype(np.float32)
    transl = rng.normal(scale=0.3, size=(B, 3)).astype(np.float32)
    jo = jbody.forward(jm, jnp.asarray(betas), jnp.asarray(pose[:, :3]),
                       jnp.asarray(pose[:, 3:]), transl=jnp.asarray(transl),
                       **{k: jnp.asarray(v) for k, v in extra.items()})
    to = tbody.forward(tm, torch.as_tensor(betas), torch.as_tensor(pose[:, :3]),
                       torch.as_tensor(pose[:, 3:]), transl=torch.as_tensor(transl),
                       **{k: torch.as_tensor(v) for k, v in extra.items()})
    for name in ("vertices", "joints", "A"):
        np.testing.assert_allclose(_np(getattr(to, name)), np.asarray(getattr(jo, name)),
                                   atol=ATOL, err_msg=name)


def test_camera_matches_jax():
    K = np.array([[80.0, 0, 33.0], [0, 90.0, 30.0], [0, 0, 1]], np.float32)
    rot = trot.axis_angle_to_matrix(torch.tensor([0.1, -0.3, 0.05])).numpy()
    t = np.array([0.1, -0.8, 2.0], np.float32)
    jc = JCamera.from_extrinsics(rot, t, K, 64, 72)
    tc = TCamera.from_extrinsics(rot, t, K, 64, 72, device="cpu")
    for name in ("world_view_transform", "full_proj_transform", "camera_center",
                 "tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(_np(getattr(tc, name)), np.asarray(getattr(jc, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_assets_and_pose_gaussians_match_jax():
    jm, juv = j_synthetic_body()
    tm, tuv = t_synthetic_body()
    J = jm.parents.shape[0]
    args = (juv.verts, juv.uvs, juv.faces_v, juv.faces_vt, np.zeros(J * 3, np.float32),
            np.zeros(4, np.float32))
    ja = j_build_assets(jm, *args, query_res=32, pad_to=64)
    ta = t_build_assets(tm, *args, query_res=32, pad_to=64, device="cpu")
    assert ta.num_valid == ja.num_valid and ta.query_res == ja.query_res
    np.testing.assert_array_equal(_np(ta.valid_idx), np.asarray(ja.valid_idx))
    for name in ("query_points", "query_lbs", "inv_mats", "uv_coords", "betas"):
        np.testing.assert_allclose(_np(getattr(ta, name)), np.asarray(getattr(ja, name)),
                                   atol=ATOL, err_msg=name)

    rng = np.random.default_rng(2)
    B, Nv = 2, ta.query_points.shape[0]
    pose = rng.normal(scale=0.3, size=(B, J * 3)).astype(np.float32)
    transl = rng.normal(scale=0.2, size=(B, 3)).astype(np.float32)
    offs = rng.normal(scale=0.01, size=(B, Nv, 3)).astype(np.float32)
    jw = j_pose_gaussians(jm, ja, jnp.asarray(pose), jnp.asarray(transl), jnp.asarray(offs))
    tw = t_pose_gaussians(tm, ta, torch.as_tensor(pose), torch.as_tensor(transl),
                          torch.as_tensor(offs))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=ATOL)
