"""The port's initial network against the JAX package's, layer by layer, at
the canonical widths (c_geom 64, hsize 128, input posmap 128, nf 32, stage
2 so that the pose encoder counts too; the assets at query 32, which sets
no parameter's shape). CPU only; it imports both packages, as the tests do.

    python3 scripts/torch_init_compare.py [--torch_default]

For every kernel it prints the standard deviation of the JAX `init_state`
(PRNGKey(0)) and of the port's AvatarNet (seed 0), their ratio, and
1/sqrt(fan_in) on the flax layout; for every bias the port's standard
deviation (JAX's are all zero; biases of one element are printed and
left out of the summary). The port's network is drawn at `init="flax"`;
with `--torch_default` at `init="torch"` after torch.manual_seed(0)
(torch's own layer defaults: kaiming_uniform(a=sqrt(5)) kernels,
U(+-1/sqrt(fan_in)) biases), the CLIs' default. The last line is a JSON
summary: the ranges of the kernel ratios and bias stds.

`init_pairs` (the walk over the JAX `init_state`'s leaves beside the
port's) serves tests/test_torch_init.py too.
"""

import argparse
import json
import math
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def init_pairs(assets, J, kw, poses=None, torch_default=False):
    """The JAX AvatarNet(**kw) `init_state` (PRNGKey(0), batch 2) on the
    JAX `assets` beside the port's AvatarNet(**kw) from a generator seeded
    0 at `init="flax"` (with `torch_default`, at `init="torch"` after
    torch.manual_seed(0)) -> (pairs,
    port state dict as numpy): a pair (port key, JAX path, JAX leaf, port
    leaf) for every leaf of the parameters and BatchNorm statistics that
    bridge.state_dict_from_jax maps."""
    import jax
    import torch

    from gaussianavatar_tpu.engine.train_step import init_state
    from gaussianavatar_tpu.models.avatar import AvatarNet as JAvatarNet

    from gaussianavatar_torch import bridge
    from gaussianavatar_torch.models.avatar import AvatarNet

    class TX0:
        def init(self, params):
            return None

    jnet = JAvatarNet(pose_dim=J * 3, pose_init=poses, **kw)
    st = jax.jit(lambda key: init_state(jnet, assets, TX0(), rng=key, batch_size=2))(
        jax.random.PRNGKey(0))
    torch.manual_seed(0)
    tnet = AvatarNet(pose_dim=J * 3, pose_init=poses, device="cpu",
                     generator=torch.Generator().manual_seed(0),
                     init="torch" if torch_default else "flax", **kw)
    sd = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    pairs = [(bridge.port_key(path), path, a, sd[bridge.port_key(path)])
             for tree in (st.params, st.batch_stats)
             for path, a in bridge._leaves(jax.tree.map(np.asarray, tree))]
    return pairs, sd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch_default", action="store_true",
                    help="the port's layers at torch's default initialisation")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")

    from gaussianavatar_tpu.models.avatar import build_avatar_assets
    from gaussianavatar_tpu.utils.synthetic import synthetic_body

    kw = dict(num_frames=2, c_geom=64, c_pose=64, inp_posmap_size=128, hsize=128, nf=32,
              train_stage=2)
    body, uv = synthetic_body()
    J = body.parents.shape[0]
    assets = build_avatar_assets(body, uv.verts, uv.uvs, uv.faces_v, uv.faces_vt,
                                 np.zeros(J * 3, np.float32), np.zeros(4, np.float32),
                                 query_res=32, pad_to=64)
    pairs, _ = init_pairs(assets, J, kw, torch_default=args.torch_default)

    ratios, bias_stds = [], []
    print(f"{'parameter':44s} {'shape (port)':18s} {'JAX std':>9s} {'port std':>9s} "
          f"{'ratio':>6s} {'1/sqrt(fan_in)':>14s}")
    for key, path, a, t in pairs:
        if path[-1] == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            js, ts = float(a.std()), float(t.std())
            ratios.append(ts / js)
            print(f"{key:44s} {str(tuple(t.shape)):18s} {js:9.4f} {ts:9.4f} {ts / js:6.3f} "
                  f"{1 / math.sqrt(fan_in):14.4f}")
        elif path[-1] == "bias" and "BatchNorm" not in path[-2]:
            if t.size > 1:  # a 1-element bias has std 0 whatever it holds
                bias_stds.append(float(t.std()))
            print(f"{key:44s} {str(tuple(t.shape)):18s} {float(a.std()):9.4f} "
                  f"{float(t.std()):9.4f}")
    print(json.dumps({"init": "torch_default" if args.torch_default else "port",
                      "kernel_std_ratio": [min(ratios), max(ratios)],
                      "bias_std": [min(bias_stds), max(bias_stds)],
                      "kernels": len(ratios), "biases": len(bias_stds)}))


if __name__ == "__main__":
    main()
