"""Port parity, the stage-1 train step with the optional terms: the AIAP
regulariser (`aiap_nn`, --use_aiap) and the decoder's positional encoding
(--pos_encoding 1), against the JAX `make_train_step` on the same state
and batch (f32 decoder on both sides).

As in tests/test_torch_train.py: both packages start from one JAX
`init_state` carried across by bridge, the JAX step runs its Pallas tile
kernels in interpret mode, and the JAX gradients are read through an optax
transformation that keeps them. The bounds are that file's: loss terms to
1e-5 relative (`aiap` included), gradients to 2e-4 of each parameter's
largest |gradient|, the BatchNorm-absorbed Dense biases (true gradient
zero) to 1e-6 of the net's gradient scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatar_tpu.config import OptimizationParams as JOpt
from gaussianavatar_tpu.engine.train_step import init_state, make_train_step as j_make_train_step
from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.ops.knn import host_knn as j_host_knn
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
from gaussianavatar_tpu.utils.synthetic import synthetic_pose

from gaussianavatar_torch import bridge
from gaussianavatar_torch.config import OptimizationParams
from gaussianavatar_torch.engine.optim import build_optimizer
from gaussianavatar_torch.engine.train_step import make_train_step
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.ops.knn import host_knn
from gaussianavatar_torch.utils.synthetic import synthetic_body
from test_torch_train import JCFG, TCFG, _loose, _record_grads

torch.set_num_threads(2)

H = W = 32
N_FRAMES, B, START_IT = 4, 2, 20
NET_KW = dict(num_frames=N_FRAMES, c_geom=8, inp_posmap_size=16, hsize=16,
              pos_encoding=True, num_emb_freqs=4)


class _TX0:
    def init(self, p):
        return None


@pytest.fixture(scope="module")
def step_pair():
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    asset_args = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt, np.zeros(J * 3, np.float32),
                  np.zeros(4, np.float32))
    ja = j_build_assets(jm, *asset_args, query_res=32, pad_to=64)
    nn = j_host_knn(np.asarray(ja.query_points[:ja.num_valid]), k=5)
    # a bent pose: non-isometric around the joints, so the AIAP term is > 0
    poses = np.stack([synthetic_pose(jm, t / N_FRAMES, amplitude=2.0) for t in range(N_FRAMES)])
    jnet = JAvatarNet(pose_dim=J * 3, pose_init=poses, **NET_KW)
    st0 = init_state(jnet, ja, _TX0(), rng=jax.random.PRNGKey(5), batch_size=B)
    st0 = st0.replace(iteration=jnp.int32(START_IT))
    opt_cfg = JOpt(use_aiap=True)

    rng = np.random.default_rng(3)
    bank = rng.integers(0, 256, size=(N_FRAMES, 3, H, W)).astype(np.uint8)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                  np.array([0.0, -0.8, 1.6], np.float32), K, H, W)
    rep = lambda x: np.repeat(np.asarray(x)[None], B, 0)
    batch = {"pose_idx": np.array([2, 0], np.int32),
             "world_view_transform": rep(cam.world_view_transform),
             "full_proj_transform": rep(cam.full_proj_transform),
             "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)}
    gates = (np.float32(opt_cfg.lambda_rgl), np.float32(1.0), np.float32(0.0))

    # the JAX step donates its state: keep the start as numpy
    params0 = jax.tree.map(np.asarray, st0.params)
    stats0 = jax.tree.map(np.asarray, st0.batch_stats)
    rec_step = j_make_train_step(jnet, jm, ja, _record_grads(), opt_cfg, H, W, (1.0, 1.0, 1.0),
                                 JCFG, aiap_nn=jnp.asarray(nn), gt_bank=jnp.asarray(bank))
    st_rec = st0.replace(opt_state=_record_grads().init(st0.params))
    st_rec, j_terms, _ = rec_step(st_rec, {k: jnp.asarray(v) for k, v in batch.items()}, *gates)
    j_grads = bridge.state_dict_from_jax(jax.tree.map(np.asarray, st_rec.opt_state), stats0)

    tm, _ = synthetic_body()
    ta = build_avatar_assets(tm, *asset_args, query_res=32, pad_to=64, device="cpu")
    t_nn = host_knn(ta.query_points[:ta.num_valid].numpy(), k=5)
    tnet = AvatarNet(pose_dim=J * 3, device="cpu", **NET_KW)
    t_opt = OptimizationParams(use_aiap=True)
    tstate = bridge.train_state_from_jax(
        tnet, build_optimizer(tnet, t_opt, steps_per_epoch=2),
        params0, stats0, START_IT)
    t_step = make_train_step(tnet, tm, ta, t_opt, H, W, (1.0, 1.0, 1.0), TCFG,
                             torch.tensor(bank), aiap_nn=torch.as_tensor(t_nn))
    t_terms, images = t_step(tstate, batch, *(float(g) for g in gates))
    t_grads = {k: p.grad.clone() for k, p in tnet.named_parameters()}
    return {"nn": (nn, t_nn), "j_terms": {k: float(v) for k, v in j_terms.items()},
            "t_terms": {k: float(v) for k, v in t_terms.items()}, "j_grads": j_grads,
            "t_grads": t_grads, "images": images, "width": tnet.pop.decoder.dense[0].in_features}


def test_train_step_with_aiap_and_pos_encoding_matches_jax(step_pair):
    r = step_pair
    np.testing.assert_array_equal(r["nn"][1], r["nn"][0])
    assert r["width"] == 8 + 2 * 2 * 4
    assert r["images"].shape == (B, 3, H, W) and bool(torch.isfinite(r["images"]).all())
    assert set(r["t_terms"]) == set(r["j_terms"])
    assert 0 < r["t_terms"]["aiap"] < 1.0
    for k, v in r["j_terms"].items():
        np.testing.assert_allclose(r["t_terms"][k], v, rtol=1e-5, atol=1e-9, err_msg=k)
    scale = max(float(r["j_grads"][name].abs().max()) for name in r["t_grads"])
    for name, tg in r["t_grads"].items():
        jg = r["j_grads"][name].numpy()
        assert np.isfinite(tg.numpy()).all(), name
        tol = 1e-6 * scale if _loose(name) else 2e-4 * np.abs(jg).max()
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=tol, err_msg=name)
    for name in ("geo_feature", "pose_embedding", "transl_embedding"):
        assert np.abs(r["j_grads"][name].numpy()).max() > 0, name
