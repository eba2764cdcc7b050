"""Write a complete reference-format dataset from the synthetic body (the
port's own copy of gaussianavatar_tpu/data/synthetic_writer.py): train/test
splits with images, masks, cam_parms.npz and smpl_parms.pth, in the layout
the data layer reads. The frames are rendered by the port's rasterizer, by
splatting the body's vertices with position-derived colours, so a machine
without JAX can make a dataset to train on.

    from gaussianavatar_torch.data.synthetic_writer import write_synthetic_dataset
    write_synthetic_dataset("/data/synth", n_train=8, image_size=512, device="cuda")
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np
import torch


def write_synthetic_dataset(
    out_dir: str,
    n_train: int = 12,
    n_test: int = 4,
    image_size: int = 128,
    body_kwargs: dict | None = None,
    device: str = "cuda",
):
    """-> (body model, UV mesh, camera); the frames are deterministic."""
    from PIL import Image

    from gaussianavatar_torch.models import body as body_mod
    from gaussianavatar_torch.ops.camera import Camera
    from gaussianavatar_torch.ops.rasterize import RasterizeConfig, rasterize_views
    from gaussianavatar_torch.utils.synthetic import synthetic_body, synthetic_pose

    model, uv = synthetic_body(**(body_kwargs or {}))
    dev_model = model.to(device)
    H = W = image_size
    f = image_size * 1.1
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    extr = np.eye(4, dtype=np.float32)
    extr[:3, 3] = [0.0, -0.8, 1.6]
    R = extr[:3, :3].transpose(1, 0)  # the dataset convention stores it transposed
    cam = Camera.from_extrinsics(R.T, extr[:3, 3], K, H, W, device=device)

    vt = model.v_template.numpy()
    n = vt.shape[0]
    colors = torch.as_tensor((vt - vt.min(0)) / (vt.max(0) - vt.min(0)), dtype=torch.float32,
                             device=device)[None]
    scales = torch.full((1, n, 3), 0.015, device=device)
    quats = torch.tensor([[1.0, 0, 0, 0]], device=device).expand(n, 4)
    opac = torch.ones((n,), device=device)
    cfg = RasterizeConfig(tile_size=16, max_tiles_per_gaussian=16)
    cam_args = (cam.world_view_transform[None], cam.full_proj_transform[None],
                cam.tan_fovx.reshape(1), cam.tan_fovy.reshape(1), H, W)
    betas = torch.zeros((1, model.shapedirs.shape[-1]), device=device)

    @torch.no_grad()
    def render_frame(pose, transl):
        pose = torch.as_tensor(pose, device=device)[None]
        out = body_mod.forward(dev_model, betas, pose[:, :3], pose[:, 3:],
                               transl=torch.as_tensor(transl, device=device)[None])
        verts = out.vertices
        img, _ = rasterize_views(verts, colors, scales, quats, opac, *cam_args,
                                 torch.ones(3, device=device), config=cfg)
        white, _ = rasterize_views(verts, torch.ones_like(colors), scales, quats, opac,
                                   *cam_args, torch.zeros(3, device=device), config=cfg)
        mask = white[0].amax(0) > 0.5
        return img[0].clamp(0, 1).cpu().numpy(), mask.cpu().numpy()

    splits = {"train": n_train, "test": n_test}
    t_global = 0
    for split, count in splits.items():
        d = join(out_dir, split)
        os.makedirs(join(d, "images"), exist_ok=True)
        os.makedirs(join(d, "masks"), exist_ok=True)
        poses, transls = [], []
        for i in range(count):
            t = (t_global + i) / (n_train + n_test)
            pose = synthetic_pose(model, t, amplitude=1.0)
            transl = np.asarray([0.02 * np.sin(7 * t), 0.0, 0.0], np.float32)
            img, mask = render_frame(pose, transl)
            arr = (img.transpose(1, 2, 0) * 255).astype(np.uint8)
            Image.fromarray(arr).save(join(d, "images", f"{i:08d}.png"))
            Image.fromarray((mask * 255).astype(np.uint8)).save(join(d, "masks", f"{i:08d}.png"))
            poses.append(pose)
            transls.append(transl)
        t_global += count
        np.savez(join(d, "cam_parms.npz"), extrinsic=extr, intrinsic=K)
        parms = {
            "beta": torch.zeros((1, model.shapedirs.shape[-1]), dtype=torch.float32),
            "body_pose": torch.as_tensor(np.stack(poses), dtype=torch.float32),
            "trans": torch.as_tensor(np.stack(transls), dtype=torch.float32),
        }
        torch.save(parms, join(d, "smpl_parms.pth"))
    return model, uv, cam
