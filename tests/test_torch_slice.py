"""Port parity, the slice: the stage-1 novel-pose render end to end.

1. A small synthetic avatar with a seeded JAX AvatarNet (f32 decoder),
   carried across by bridge.state_dict_from_jax, rendered by JAX
   `make_cached_render_fn` (one capacity tier deep enough for every tile,
   stable sort, so its capacity overflow is 0) and by the port's cached
   renderer, B=2.
2. The CLI: a tiny JAX model directory is converted by
   scripts/convert_jax_checkpoint_torch.py, then rendered by
   `python -m gaussianavatar_torch.render_novel_pose --device cpu` and by the
   JAX render_novel_pose.py on the same poses.

The two sides pose the gaussians with float32 LBS whose sums run in
different orders, so world positions differ by ulps. Where such a
difference moves a gaussian's radius (ceil), tile rect (floor) or depth key
across an integer, a pixel's blend order or membership changes and that
pixel differs visibly; everywhere else the images agree to float noise.
So the bound is stated as: at most 0.5% of pixel values differ by more
than 1e-4, and none by more than 0.25."""

import os
import sys
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaussianavatar_tpu.engine.train_step import init_state, make_cached_render_fn as j_cached
from gaussianavatar_tpu.engine.train_step import precompute_canonical as j_precompute
from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet
from gaussianavatar_tpu.models.avatar import build_avatar_assets as j_build_assets
from gaussianavatar_tpu.ops.camera import Camera as JCamera
from gaussianavatar_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gaussianavatar_tpu.utils.synthetic import synthetic_body as j_synthetic_body
from gaussianavatar_tpu.utils.synthetic import synthetic_pose

from gaussianavatar_torch import bridge
from gaussianavatar_torch.engine.inference import (
    make_cached_render_fn, make_render_fn, precompute_canonical,
)
from gaussianavatar_torch.models.avatar import AvatarNet, build_avatar_assets
from gaussianavatar_torch.ops.rasterize import RasterizeConfig
from gaussianavatar_torch.utils.synthetic import synthetic_body

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOISE, FRAC, MAX_DIFF = 1e-4, 5e-3, 0.25


def assert_images_close(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.max() <= MAX_DIFF, d.max()
    assert (d > NOISE).mean() <= FRAC, (d > NOISE).mean()


class _TX0:
    def init(self, p):
        return None


def test_cached_render_matches_jax():
    jm, uv = j_synthetic_body()
    J = jm.parents.shape[0]
    args = (uv.verts, uv.uvs, uv.faces_v, uv.faces_vt, np.zeros(J * 3, np.float32),
            np.zeros(4, np.float32))
    ja = j_build_assets(jm, *args, query_res=48, pad_to=64)
    jnet = JAvatarNet(num_frames=4, pose_dim=J * 3, c_geom=8, inp_posmap_size=16, hsize=16)
    st = init_state(jnet, ja, _TX0(), rng=jax.random.PRNGKey(11), batch_size=1)
    params = jax.tree.map(np.asarray, st.params)
    stats = jax.tree.map(np.asarray, st.batch_stats)

    H = W = 64
    B, it = 2, 10  # iteration 10: ~5mm gaussians, the scale of a trained avatar
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32)
    cam = JCamera.from_extrinsics(np.eye(3, dtype=np.float32),
                                  np.array([0.0, -0.8, 1.6], np.float32), K, H, W)
    tile = lambda x: np.repeat(np.asarray(x)[None], B, 0)
    batch = {
        "pose_idx": np.arange(B, dtype=np.int32),
        "pose_data": np.stack([synthetic_pose(jm, 0.3 * b) for b in range(B)]),
        "transl_data": np.array([[0.0, 0.0, 0.0], [0.03, 0.0, 0.0]], np.float32),
        "world_view_transform": tile(cam.world_view_transform),
        "full_proj_transform": tile(cam.full_proj_transform),
        "tan_fovx": tile(cam.tan_fovx), "tan_fovy": tile(cam.tan_fovy),
    }
    jcfg = JRasterizeConfig(tile_size=16, tile_capacity=2048, max_tiles_per_gaussian=4,
                            backend="xla", sort_stable=True)
    jrender = j_cached(jnet, jm, ja, H, W, (1.0, 1.0, 1.0), jcfg, with_overflow=True)
    jcache = j_precompute(jnet, ja, params, stats)
    j_img, j_over = jrender(jcache, params, {k: jnp.asarray(v) for k, v in batch.items()},
                            jnp.int32(it))

    tm, _ = synthetic_body()
    ta = build_avatar_assets(tm, *args, query_res=48, pad_to=64, device="cpu")
    tnet = AvatarNet(4, J * 3, c_geom=8, inp_posmap_size=16, hsize=16, device="cpu").eval()
    tnet.load_state_dict(bridge.state_dict_from_jax(params, stats))
    trender = make_cached_render_fn(tnet, tm, ta, H, W, (1.0, 1.0, 1.0),
                                    RasterizeConfig(16, 4), with_overflow=True)
    t_img, t_over = trender(precompute_canonical(tnet, ta), batch, it)

    # the JAX overflow is only the footprint cap's (the tier holds every row)
    assert int(t_over) == int(j_over)
    assert t_img.shape == (B, 3, H, W) and bool(torch.isfinite(t_img).all())
    assert (t_img < 0.99).float().mean() > 0.05  # the avatar is in view
    assert_images_close(t_img.numpy(), j_img)
    # the full-decode renderer decodes per call and renders the same frames
    full = make_render_fn(tnet, tm, ta, H, W, (1.0, 1.0, 1.0), RasterizeConfig(16, 4))
    assert torch.equal(full(batch, it), t_img)


SMALL_ARGS = [
    "--dataset_type", "synthetic", "--query_posmap_size", "32", "--inp_posmap_size", "16",
    "--c_geom", "8", "--c_pose", "8", "--hsize", "16", "--nf", "8", "--bf16_decoder", "0",
    "--tile_size", "16", "--render_max_tiles_per_gaussian", "4", "--render_sort_stable", "1",
    "--tile_capacity", "2048", "--tile_capacity_hi", "0", "--backend", "xla",
]


def test_novel_pose_cli_matches_jax(tmp_path, capsys):
    from PIL import Image

    from gaussianavatar_tpu.config import build_parser, extract_config
    from gaussianavatar_tpu.data.synthetic_writer import write_synthetic_dataset
    from gaussianavatar_tpu.engine.checkpoint import save_checkpoint
    from gaussianavatar_tpu.engine.optim import build_optimizer
    from gaussianavatar_tpu.engine.setup import setup_avatar

    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    write_synthetic_dataset(data, n_train=3, n_test=5, image_size=32)
    common = ["-s", data, "-m", out, "--test_folder", join(data, "test")]
    cfg = extract_config(build_parser().parse_args(common + SMALL_ARGS))
    cfg.save(join(out, "cfg_args.json"))
    bundle = setup_avatar(cfg, train=False)
    state = init_state(bundle.net, bundle.assets, _TX0(), rng=jax.random.PRNGKey(3), batch_size=1)
    tx = build_optimizer(state.params, cfg.opt, 1, cfg.model.train_stage)
    save_checkpoint(out, 1, state.replace(opt_state=tx.init(state.params)))

    sys.path.insert(0, join(REPO, "scripts"))
    import convert_jax_checkpoint_torch

    convert_jax_checkpoint_torch.main(["-m", out])
    assert os.path.exists(join(out, "net", "iteration_1", "net_torch.pt"))

    from gaussianavatar_torch import render_novel_pose as t_cli

    t_cli.main(["-m", out, "--image_size", "64", "--device", "cpu"])
    assert "ignores the TPU-only raster knobs" in capsys.readouterr().out
    names = sorted(os.listdir(join(out, "novel_pose")))
    assert names == [f"{i:05d}.png" for i in range(5)]
    ours = {n: np.asarray(Image.open(join(out, "novel_pose", n)), np.float32) / 255 for n in names}

    sys.path.insert(0, REPO)
    import render_novel_pose as j_cli

    j_cli.main(["-m", out, "--image_size", "64"])
    for n in names:
        theirs = np.asarray(Image.open(join(out, "novel_pose", n)), np.float32) / 255
        # 8-bit frames: float noise may flip one level
        assert_images_close(np.where(np.abs(ours[n] - theirs) <= 1 / 255 + 1e-6, theirs, ours[n]),
                            theirs)
