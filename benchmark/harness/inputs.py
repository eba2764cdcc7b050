"""What a run feeds both sides, made from the configuration, the traffic
mix and --seed: the body, the frames' poses and cameras, the training
frames' ground truth, stage 2's input posmaps, and the weights.

Every seed gets the same sizes and the same set of poses; the seed draws
the weights, the order in which the frames are visited, and where in the
pose sequence a render starts. The weights are drawn on the device by one
generator in one call (`weights`); the ground truth is the body's vertices
splatted by the plain reference renderer.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference import body as rbody
from benchmark.reference import net as rnet
from benchmark.reference import raster as rr


def make_body(cfg: dict) -> rbody.Body:
    b = cfg["body"]
    return rbody.tube_body(b["n_rings"], b["n_cols"], b["n_joints"], b["n_betas"],
                           b["height"], b["seed"])


def frame_camera(mix: dict, size: int) -> dict:
    """The one static camera of a mix, framing the body: identity rotation,
    translation `camera_t`, focal `focal_scale` x size, centred."""
    f = mix["focal_scale"] * size
    K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
    return rr.camera(np.eye(3, dtype=np.float32), np.asarray(mix["camera_t"], np.float32), K,
                     size, size)


def poses(body: rbody.Body, n: int, amplitude: float) -> tuple:
    """n poses of one smooth cycle -> (pose (n, 3J), transl (n, 3))."""
    J = body.parents.shape[0]
    ts = np.arange(n) / n
    pose = np.stack([rbody.wiggle_pose(J, t, amplitude) for t in ts]).astype(np.float32)
    transl = np.stack([[0.02 * np.sin(7 * t), 0.0, 0.0] for t in ts]).astype(np.float32)
    return pose, transl


def ground_truth(body: rbody.Body, pose: np.ndarray, transl: np.ndarray, cam: dict, size: int,
                 device, chunk: int = 8) -> torch.Tensor:
    """The frames the avatar is trained on, (n, 3, S, S) uint8: the posed
    body's vertices as gaussians of 1.5 cm, coloured by their rest position,
    on white (the reference renderer, 16 px tiles, 16 tiles a gaussian)."""
    vt = body.v_template
    col = torch.as_tensor((vt - vt.min(0)) / (vt.max(0) - vt.min(0)), device=device)
    out = []
    for s in range(0, pose.shape[0], chunk):
        p = torch.as_tensor(pose[s:s + chunk], device=device)
        B = p.shape[0]
        verts, _ = rbody.skin(body, p, torch.as_tensor(transl[s:s + chunk], device=device))
        V = verts.shape[1]
        cb = {k: torch.as_tensor(np.stack([v] * B), device=device) for k, v in cam.items()}
        pr = rr.project(verts, torch.full((B, V, 3), 0.015, device=device),
                        cb["world_view_transform"], cb["full_proj_transform"], cb["tan_fovx"],
                        cb["tan_fovy"], size, size)
        img, _ = rr.render(pr, col[None].expand(B, V, 3), torch.ones((B, V), device=device),
                           torch.ones(3, device=device), size, size, 16, 16)
        out.append(torch.round(img.clamp(0, 1) * 255).to(torch.uint8))
    return torch.cat(out)


def input_posmaps(body: rbody.Body, cfg: dict, pose: np.ndarray, transl: np.ndarray,
                  device, chunk: int = 64) -> torch.Tensor:
    """Stage 2's input posmaps (n, 3, S, S) float32: each frame's posed body
    over the UV atlas at the input resolution."""
    raster = rbody.uv_raster(body.uvs, body.faces_vt, cfg["inp_posmap_size"])
    out = [rbody.posmaps(body, raster, torch.as_tensor(pose[s:s + chunk], device=device),
                         torch.as_tensor(transl[s:s + chunk], device=device))
           for s in range(0, pose.shape[0], chunk)]
    return torch.cat(out)


def weights(cfg: dict, n_frames: int, pose: np.ndarray, transl: np.ndarray, seed: int,
            device) -> dict:
    """The network's starting weights, name -> float32 tensor on `device`:
    every drawn leaf sliced from one normal draw of a generator on the
    device seeded with `seed`; kernels N(0, 1 / fan_in) (flax's
    lecun_normal scale, untruncated), geometry features 0.01 N(0, 1),
    biases 0 but the scale head's (reference/net.param_specs), BatchNorm
    scales 1, the embeddings the frames' poses."""
    specs = rnet.param_specs(cfg, n_frames, pose.shape[1])
    drawn = [(k, s, how) for k, (s, how) in specs.items() if how == "geo" or how.startswith("lecun")]
    total = sum(int(np.prod(s)) for _, s, _ in drawn)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    z = torch.randn(total, generator=g, device=device)
    P, at = {}, 0
    for k, s, how in drawn:
        n = int(np.prod(s))
        scale = 0.01 if how == "geo" else float(how.split(":")[1]) ** -0.5
        P[k] = (z[at:at + n] * scale).reshape(s)
        at += n
    for k, (s, how) in specs.items():
        if how in ("zeros", "ones"):
            P[k] = (torch.zeros if how == "zeros" else torch.ones)(s, device=device)
        elif how.startswith("const:"):
            P[k] = torch.full(s, float(how.split(":")[1]), device=device)
    P["pose_embedding"] = torch.as_tensor(pose, device=device)
    P["transl_embedding"] = torch.as_tensor(transl, device=device)
    return P


def make(cfg: dict, mix: dict, seed: int, device) -> SimpleNamespace:
    """Everything a cell's two sides share."""
    body = make_body(cfg)
    size = mix["image_size"]
    cam = frame_camera(mix, size)
    n = mix["frames"]
    pose, transl = poses(body, n, mix["pose_amplitude"])
    x = SimpleNamespace(body=body, cam=cam, size=size, pose=pose, transl=transl, n=n)
    if mix["kind"] == "train":
        x.gt = ground_truth(body, pose, transl, cam, size, device)
    if cfg["train_stage"] == 2:
        x.posmaps = input_posmaps(body, cfg, pose, transl, device)
    x.weights = weights(cfg, n, pose, transl, seed, device)
    return x
