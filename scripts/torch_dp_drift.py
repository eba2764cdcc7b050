"""How far `--dp 2` leaves `--dp 1` over 10 stage-1 steps, in the JAX
package and in the port, on the CPU (ROADMAP F16): at the bf16 decoder and
at the f32 one.

Both packages start from one JAX `init_state` (carried into the port by
`gaussianavatar_torch.bridge`), train with their own Adam groups on the
same 10 global batches of 4 frames at small widths (query 32, c_geom 8,
hsize 16, 32^2 images). JAX: `make_train_step` jitted, `--dp 2` as
`replicate` + `shard_batch` on 2 devices of the 8-device virtual CPU mesh.
The port: `make_train_step`, `--dp 2` as two gloo ranks
(`parallel/mesh.spawn_ranks`), with the BatchNorm statistics synced and,
as a control, not. Prints per dtype the largest relative difference of a
step's loss from each package's `--dp 1`, then one JSON line. Like the
checkpoint converters it imports both packages, so it runs here, not on
the card.

    python3 scripts/torch_dp_drift.py      # ~10 min on a few CPU cores
"""

import os
import sys
import tempfile

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

H = W = 32
N_FRAMES = B = 4
STEPS = 10
START_IT = 20


def _port_setup(inputs):
    from gaussianavatar_torch.config import OptimizationParams
    from gaussianavatar_torch.engine.optim import build_optimizer
    from gaussianavatar_torch.engine.train_step import TrainState, make_train_step
    from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
    from gaussianavatar_torch.ops.rasterize import RasterizeConfig
    from gaussianavatar_torch.utils.synthetic import synthetic_body

    tm, uv = synthetic_body()
    J = tm.parents.shape[0]
    ta = build_avatar_assets(tm, uv.verts, uv.uvs, uv.faces_v, uv.faces_vt,
                             np.zeros(J * 3, np.float32), np.zeros(4, np.float32),
                             query_res=32, pad_to=64, device="cpu")
    net = AvatarNet(pose_dim=J * 3, device="cpu", compute_dtype=inputs["dtype"],
                    **inputs["net_kw"])
    net.load_state_dict(inputs["sd"])
    state = TrainState(net, build_optimizer(net, OptimizationParams(), steps_per_epoch=1),
                       START_IT)
    step = make_train_step(net, tm, ta, OptimizationParams(), H, W, (1.0, 1.0, 1.0),
                           RasterizeConfig(16, 16), inputs["bank"])
    return state, step


def _port_rank(path, sync):
    from unittest import mock

    from gaussianavatar_torch.parallel import mesh

    inputs = torch.load(path, weights_only=False)
    state, step = _port_setup(inputs)
    grp = mesh.group()
    totals = []
    ctx = mock.patch.object(mesh, "syncs_batch_stats", lambda: False) if not sync else \
        mock.MagicMock()
    with ctx:
        for b in inputs["batches"]:
            terms, _ = step(state, mesh.shard_batch(b, grp), *inputs["gates"])
            totals.append(float(terms["total"]))
    if grp.rank == 0:
        torch.save(totals, path + f".dp2_sync{int(sync)}")


def main():
    import jax
    import jax.numpy as jnp

    from gaussianavatar_tpu.config import OptimizationParams as JOpt
    from gaussianavatar_tpu.engine.optim import build_optimizer as j_build_optimizer
    from gaussianavatar_tpu.engine.train_step import init_state, make_train_step as j_step
    from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
    from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
    from gaussianavatar_tpu.ops.camera import Camera as JCamera
    from gaussianavatar_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
    from gaussianavatar_tpu.parallel import make_mesh, replicate, shard_batch
    from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
    from gaussianavatar_tpu.utils.synthetic import synthetic_pose

    from gaussianavatar_torch import bridge
    from gaussianavatar_torch.parallel import mesh

    jax.config.update("jax_platforms", "cpu")
    to_np = lambda t: jax.tree.map(np.asarray, t)
    out = {}
    work = tempfile.mkdtemp(prefix="dp_drift_")
    for dtype in ("bfloat16", "float32"):
        net_kw = dict(num_frames=N_FRAMES, c_geom=8, inp_posmap_size=16, hsize=16)
        jm, uv = j_synthetic_body()
        J = jm.parents.shape[0]
        ja = j_build_assets(jm, uv.verts, uv.uvs, uv.faces_v, uv.faces_vt,
                            np.zeros(J * 3, np.float32), np.zeros(4, np.float32),
                            query_res=32, pad_to=64)
        poses = np.stack([synthetic_pose(jm, t / N_FRAMES) for t in range(N_FRAMES)])
        jnet = JAvatarNet(pose_dim=J * 3, pose_init=poses, compute_dtype=dtype, **net_kw)

        class TX0:
            def init(self, p):
                return None
        st0 = jax.jit(lambda key: init_state(jnet, ja, TX0(), rng=key, batch_size=B))(
            jax.random.PRNGKey(3))
        st0 = st0.replace(iteration=jnp.int32(START_IT))
        sd0 = bridge.state_dict_from_jax(to_np(st0.params), to_np(st0.batch_stats))
        rng = np.random.default_rng(4)
        bank = rng.integers(0, 256, size=(N_FRAMES, 3, H, W)).astype(np.uint8)
        K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
        cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                      np.array([0.0, -0.8, 1.6], np.float32), K, H, W)
        rep = lambda x: np.repeat(np.asarray(x)[None], B, 0)
        batches = [{"pose_idx": rng.permutation(N_FRAMES).astype(np.int32),
                    "world_view_transform": rep(cam.world_view_transform),
                    "full_proj_transform": rep(cam.full_proj_transform),
                    "tan_fovx": rep(cam.tan_fovx), "tan_fovy": rep(cam.tan_fovy)}
                   for _ in range(STEPS)]
        gates = (float(np.float32(JOpt().lambda_rgl)), 1.0, 0.0)

        tx = j_build_optimizer(st0.params, JOpt(), steps_per_epoch=1, train_stage=1)
        jcfg = JRasterizeConfig(tile_size=16, tile_capacity=1024, max_tiles_per_gaussian=16,
                                backend="xla", sort_stable=True)
        step = j_step(jnet, jm, ja, tx, JOpt(), H, W, (1.0, 1.0, 1.0), jcfg,
                      gt_bank=jnp.asarray(bank))
        copy = lambda t: jax.tree.map(lambda x: jnp.array(x), t)
        res = {}
        for dp in (1, 2):
            st = copy(st0).replace(opt_state=tx.init(st0.params))
            m = make_mesh(dp) if dp > 1 else None
            if m is not None:
                st = replicate(st, m)
            totals = []
            for b in batches:
                jb = {k: jnp.asarray(v) for k, v in b.items()}
                if m is not None:
                    jb = shard_batch(jb, m)
                st, terms, _ = step(st, jb, *(np.float32(g) for g in gates))
                totals.append(float(terms["total"]))
            res[f"jax_dp{dp}"] = totals

        inputs = {"sd": sd0, "bank": torch.tensor(bank), "batches": batches, "gates": gates,
                  "net_kw": net_kw, "dtype": dtype}
        path = os.path.join(work, f"inputs_{dtype}.pt")
        torch.save(inputs, path)
        state, tstep = _port_setup(inputs)
        res["port_dp1"] = [float(tstep(state, b, *gates)[0]["total"]) for b in batches]
        for sync in (True, False):
            mesh.spawn_ranks(_port_rank, 2, "cpu", (path, sync), timeout_s=600)
            res[f"port_dp2_sync{int(sync)}"] = torch.load(path + f".dp2_sync{int(sync)}")
        apart = lambda a, b: max(abs(y - x) / abs(x) for x, y in zip(res[a], res[b]))
        out[dtype] = {
            "jax_dp2_vs_dp1": apart("jax_dp1", "jax_dp2"),
            "port_dp2_vs_dp1": apart("port_dp1", "port_dp2_sync1"),
            "port_dp2_nosync_vs_dp1": apart("port_dp1", "port_dp2_sync0"),
            "port_dp1_vs_jax_dp1": apart("jax_dp1", "port_dp1"),
            "first_step": {k: v[0] for k, v in res.items()},
            "last_step": {k: v[-1] for k, v in res.items()},
        }
        print(dtype, {k: v for k, v in out[dtype].items() if k.endswith("dp1")}, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
