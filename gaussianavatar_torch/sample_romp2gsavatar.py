"""Convert a ROMP / InstantAvatar-style monocular capture into the dataset
layout (the port's counterpart of scripts/sample_romp2gsavatar.py): read
{images/, masks/, cameras.npz, poses_optimized.npz}, split it by the
InstantAvatar rule (the first 80% of the frames train, the rest test),
renumber the frames and write {split}/{images,masks,cam_parms.npz,
smpl_parms.pth}.

    python -m gaussianavatar_torch.sample_romp2gsavatar --input <romp_dir> --output <data>

A frame's mask is `masks/<image name>`, else `masks/<stem>.png` or `.jpg`.
`smpl_parms.pth` is a `torch.save`d dict of float32 tensors (`beta`,
`body_pose` = global orient + body pose, `trans`), which the JAX package's
reader reads too. A file conversion on the host: nothing runs on a device.
"""

import os
import shutil
import sys
from argparse import ArgumentParser
from os.path import join


def instantavatar_split(n: int):
    """InstantAvatar rule: first ~80% train (every frame), last 20% test."""
    n_train = int(n * 0.8)
    return list(range(n_train)), list(range(n_train, n))


def main(argv=None):
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", required=True, help="ROMP/InstantAvatar capture dir")
    parser.add_argument("--output", required=True)
    parser.add_argument("--poses_file", default="poses_optimized.npz")
    parser.add_argument("--cameras_file", default="cameras.npz")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    import numpy as np
    import torch

    with np.load(join(args.input, args.cameras_file)) as cams:
        intrinsic = np.asarray(cams["intrinsic"], np.float32).reshape(3, 3)
        extrinsic = (np.asarray(cams["extrinsic"], np.float32).reshape(4, 4)
                     if "extrinsic" in cams else np.eye(4, dtype=np.float32))

    with np.load(join(args.input, args.poses_file)) as f:
        poses = {k: np.asarray(f[k]) for k in f.files}
    # ROMP keys: global_orient (N,3), body_pose (N,69), transl (N,3), betas
    if "body_pose" in poses and "global_orient" in poses:
        body_pose = np.concatenate([poses["global_orient"], poses["body_pose"]], axis=1)
    else:
        body_pose = poses["pose"] if "pose" in poses else poses["thetas"]
    trans = np.asarray(poses.get("transl", poses.get("trans")), np.float32)
    betas = np.asarray(poses.get("betas", poses.get("beta")), np.float32).reshape(1, -1)

    img_dir = join(args.input, "images")
    names = sorted(os.listdir(img_dir))
    n = min(len(names), len(body_pose))
    train_ids, test_ids = instantavatar_split(n)

    for split, ids in (("train", train_ids), ("test", test_ids)):
        d = join(args.output, split)
        os.makedirs(join(d, "images"), exist_ok=True)
        os.makedirs(join(d, "masks"), exist_ok=True)
        sp, st = [], []
        for new_i, i in enumerate(ids):
            base = names[i]
            dst = f"{new_i:08d}" + os.path.splitext(base)[1]
            shutil.copy(join(img_dir, base), join(d, "images", dst))
            mask_src = join(args.input, "masks", base)
            if not os.path.exists(mask_src):
                stem = os.path.splitext(base)[0]
                for ext in (".png", ".jpg"):
                    if os.path.exists(join(args.input, "masks", stem + ext)):
                        mask_src = join(args.input, "masks", stem + ext)
                        break
            shutil.copy(mask_src, join(d, "masks", f"{new_i:08d}.png"))
            sp.append(body_pose[i])
            st.append(trans[i])
        np.savez(join(d, "cam_parms.npz"), extrinsic=extrinsic, intrinsic=intrinsic)
        parms = {
            "beta": betas,
            "body_pose": np.stack(sp).astype(np.float32),
            "trans": np.stack(st).astype(np.float32),
        }
        torch.save({k: torch.as_tensor(v) for k, v in parms.items()}, join(d, "smpl_parms.pth"))
        print(f"{split}: {len(ids)} frames")
    print("done ->", args.output)


if __name__ == "__main__":
    main()
