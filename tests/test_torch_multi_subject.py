"""Port parity, multi-subject training (parallel/multi_subject.py): one
lockstep step of two subjects of unequal frame counts (6 and 4), each with
its own betas, GT and embedding rows, against the JAX package's
`parallel/grid.make_grid_step` on the virtual 8-device mesh (2 subjects x
2-way dp), from the JAX grid's stacked state converted slot by slot
(bridge.subject_slot, the embedding rows cut back to each subject's own
count), f32 decoder (F1), SGD(1.0) on both sides so that the update is
the gradient (tests/test_multi_cli_e2e.py's construction).

Bounds: the loss of each slot rtol 1e-5, atol 1e-6; the decoder's,
geo_feature's and the embeddings' updates atol 2e-4, rtol 1e-3 (the JAX
test's own bounds for its multi-subject step against single-subject
training). Then each slot of the port's multi-subject step against the
port's single-subject step of that subject alone: bit-identical on the CPU.

The JAX step runs its Pallas blend in interpret mode (test_torch_train:
the only JAX blend whose backward passes the 0.99 clamp straight
through, as H-bwd does)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussianavatar_tpu.config import OptimizationParams as JOpt
from gaussianavatar_tpu.engine.train_step import init_state
from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.parallel.grid import make_grid_mesh, make_grid_step
from gaussianavatar_tpu.parallel.multi_subject import stack_assets, stack_subjects
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
from gaussianavatar_tpu.utils.synthetic import synthetic_pose

from gaussianavatar_torch import bridge
from gaussianavatar_torch.config import OptimizationParams
from gaussianavatar_torch.engine.setup import AvatarBundle
from gaussianavatar_torch.engine.train_step import TrainState, make_train_step
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.parallel.multi_subject import Subject, make_multi_subject_step
from gaussianavatar_torch.utils.synthetic import synthetic_body

from test_torch_frame_dp import SGD
from test_torch_train import JCFG, TCFG, _TX0

torch.set_num_threads(2)

H = W = 32
FRAMES = (6, 4)
B, START_IT = 2, 20
NET_KW = dict(c_geom=8, inp_posmap_size=16, hsize=16)
to_np = lambda t: jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def grid():
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    rng = np.random.default_rng(0)
    betas = [(0.5 * rng.normal(size=4)).astype(np.float32) for _ in FRAMES]
    asset_args = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt, np.zeros(J * 3, np.float32))
    j_assets = [j_build_assets(jm, *asset_args, b, query_res=32, pad_to=64) for b in betas]
    n_max = max(FRAMES)
    poses = [np.stack([synthetic_pose(jm, (t + 0.5 * s) / n) for t in range(n)])
             for s, n in enumerate(FRAMES)]
    # the JAX package pads every subject's embedding rows to the largest
    # subject (multi_loop.build_subject_bundles)
    pad = lambda p: np.concatenate([p, np.zeros((n_max - len(p), p.shape[1]), p.dtype)])
    j_nets = [JAvatarNet(num_frames=n_max, pose_dim=J * 3, pose_init=pad(p),
                         transl_init=np.zeros((n_max, 3), np.float32), **NET_KW)
              for p in poses]
    tx = optax.sgd(1.0)
    singles = []
    for s, (net, a) in enumerate(zip(j_nets, j_assets)):
        st = jax.jit(lambda key: init_state(net, a, _TX0(), rng=key, batch_size=B))(
            jax.random.PRNGKey(s))
        singles.append(st.replace(opt_state=tx.init(st.params), iteration=jnp.int32(START_IT)))
    start = [(to_np(st.params), to_np(st.batch_stats)) for st in singles]
    stacked = stack_subjects(singles)
    # the step donates its state: the stacked start as numpy first
    stacked_start = (to_np(stacked.params), to_np(stacked.batch_stats))

    banks = [rng.integers(0, 256, size=(n, 3, H, W)).astype(np.uint8) for n in FRAMES]
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                  np.array([0.0, -0.8, 1.6], np.float32), K, H, W)
    rep = lambda x: np.repeat(np.asarray(x)[None], B, 0)
    batches = [{"pose_idx": rng.choice(n, B, replace=False).astype(np.int32),
                "world_view_transform": rep(cam.world_view_transform),
                "full_proj_transform": rep(cam.full_proj_transform),
                "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)} for n in FRAMES]
    gates = (np.float32(JOpt().lambda_rgl), np.float32(1.0), np.float32(0.0))

    mesh = make_grid_mesh(len(FRAMES), 2)
    step, place_subject, place_batch = make_grid_step(
        j_nets[0], jm, stack_assets(j_assets), tx, JOpt(), H, W, (1.0, 1.0, 1.0), JCFG, mesh)
    feeds = [dict(b, original_image=bank[b["pose_idx"]].astype(np.float32) / 255.0)
             for b, bank in zip(batches, banks)]
    stacked_feed = place_batch({k: jnp.stack([jnp.asarray(f[k]) for f in feeds])
                                for k in feeds[0]})
    new_state, terms, _ = step(place_subject(stacked), stacked_feed,
                               *(jnp.float32(g) for g in gates))
    return dict(jm=jm, betas=betas, asset_args=asset_args, start=start,
                stacked_start=stacked_start, banks=banks,
                batches=batches, gates=[float(g) for g in gates], J=J,
                j_total=np.asarray(terms["total"]), j_params=to_np(new_state.params),
                j_stats=to_np(new_state.batch_stats))


def _port_subjects(g):
    """The two port subjects from the JAX grid's stacked start, slot by
    slot."""
    tm, _ = synthetic_body()
    subjects = []
    for s, n in enumerate(FRAMES):
        assets = build_avatar_assets(tm, *g["asset_args"], g["betas"][s], query_res=32,
                                     pad_to=64, device="cpu")
        net = AvatarNet(num_frames=n, pose_dim=g["J"] * 3, device="cpu", **NET_KW)
        params, stats = g["stacked_start"]
        net.load_state_dict(bridge.state_dict_from_jax(bridge.subject_slot(params, s, n),
                                                       bridge.subject_slot(stats, s)))
        subjects.append(Subject(AvatarBundle(tm, assets, net, None),
                                TrainState(net, SGD(net), START_IT),
                                torch.tensor(g["banks"][s])))
    return subjects


@pytest.fixture(scope="module")
def port(grid):
    subjects = _port_subjects(grid)
    step = make_multi_subject_step(subjects, OptimizationParams(), H, W, (1.0, 1.0, 1.0), TCFG)
    results = step(grid["batches"], *grid["gates"])
    return subjects, results


def test_bridge_takes_a_subject_slot(grid):
    """The stacked JAX start holds each subject in its slot, its embedding
    rows padded to 6; subject_slot gives back the subject's own rows."""
    stacked = grid["stacked_start"][0]
    padded = bridge.subject_slot(stacked, 1)
    assert padded["pose_embedding"].shape[0] == max(FRAMES)
    assert not padded["pose_embedding"][FRAMES[1]:].any()
    for s, n in enumerate(FRAMES):
        sd = bridge.state_dict_from_jax(bridge.subject_slot(stacked, s, n), grid["start"][s][1])
        assert sd["pose_embedding"].shape[0] == sd["transl_embedding"].shape[0] == n
        np.testing.assert_array_equal(sd["pose_embedding"].numpy(),
                                      grid["start"][s][0]["pose_embedding"][:n])
        np.testing.assert_array_equal(sd["geo_feature"].numpy(), bridge.to_port(
            ("geo_feature",), grid["start"][s][0]["geo_feature"]).numpy())


def test_multi_subject_step_matches_jax_grid(grid, port):
    """Each slot's loss, and its decoder, geo_feature and embedding updates
    under SGD(1.0), against the JAX grid step's slot."""
    subjects, results = port
    assert len(results) == len(FRAMES)
    for s, (sub, (terms, images)) in enumerate(zip(subjects, results)):
        assert images.shape == (B, 3, H, W) and bool(torch.isfinite(images).all())
        np.testing.assert_allclose(float(terms["total"]), grid["j_total"][s], rtol=1e-5,
                                   atol=1e-6, err_msg=f"slot {s}")
        assert sub.state.iteration == START_IT + 1
        j_sd = bridge.state_dict_from_jax(bridge.subject_slot(grid["j_params"], s, FRAMES[s]),
                                          bridge.subject_slot(grid["j_stats"], s))
        start = bridge.state_dict_from_jax(*grid["start"][s])
        start = {k: v[:FRAMES[s]] if k.endswith("_embedding") else v for k, v in start.items()}
        own = sub.bundle.net.state_dict()
        keys = [k for k in own if k.startswith("pop.") or k in
                ("geo_feature", "pose_embedding", "transl_embedding")]
        for k in keys:
            assert own[k].shape == j_sd[k].shape, k
            np.testing.assert_allclose(own[k].numpy(), j_sd[k].numpy(), rtol=1e-3, atol=2e-4,
                                       err_msg=f"slot {s} {k}")
        for k in ("geo_feature", "pose_embedding"):
            assert not torch.equal(own[k], start[k]), f"slot {s}: {k} did not move"


def test_slot_equals_single_subject_step(grid, port):
    """Each slot of the multi-subject step is the port's single-subject step
    of that subject, bit for bit: the same parameters, BatchNorm
    statistics, gradients and terms."""
    subjects, results = port
    for s, (sub, (terms, _)) in enumerate(zip(subjects, results)):
        alone = _port_subjects(grid)[s]
        one = make_train_step(alone.bundle.net, alone.bundle.body_model, alone.bundle.assets,
                              OptimizationParams(), H, W, (1.0, 1.0, 1.0), TCFG, alone.gt_bank)
        t_alone, _ = one(alone.state, grid["batches"][s], *grid["gates"])
        assert terms.keys() == t_alone.keys()
        for k in terms:
            assert torch.equal(terms[k], t_alone[k]), (s, k)
        for (k, v), (_, w) in zip(sub.bundle.net.state_dict().items(),
                                  alone.bundle.net.state_dict().items()):
            assert torch.equal(v, w), (s, k)
        assert sub.state.optimizer.grads.keys() == alone.state.optimizer.grads.keys()
        for k, g in sub.state.optimizer.grads.items():
            assert torch.equal(g, alone.state.optimizer.grads[k]), (s, k)
