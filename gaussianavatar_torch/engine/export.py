"""Gaussians in the standard 3D-Gaussian-Splatting PLY layout (the port's
copy of gaussianavatar_tpu/engine/export.py; graphdeco-inria convention:
x/y/z, normals, f_dc_* SH0 colours, opacity logit, log scales, wxyz
quaternion), so a trained avatar opens in any 3DGS viewer. numpy only: the
writer's bytes equal the JAX package's for the same arrays."""

from __future__ import annotations

import numpy as np

_SH_C0 = 0.28209479177387814


def export_gaussians_ply(
    path: str,
    means: np.ndarray,        # (N, 3)
    colors: np.ndarray,       # (N, 3) in [0, 1]
    scales: np.ndarray,       # (N, 3) world-space
    opacities: np.ndarray,    # (N,) in [0, 1]
    rotations: np.ndarray,    # (N, 4) wxyz
) -> str:
    """Write the binary little-endian PLY: SH0 `f_dc` = (colour - 0.5) /
    C0, the opacity's logit with the opacity clipped to [1e-4, 1 - 1e-4],
    log scales floored at 1e-8."""
    N = means.shape[0]
    f_dc = (np.asarray(colors, np.float32) - 0.5) / _SH_C0
    op = np.clip(np.asarray(opacities, np.float32).reshape(-1), 1e-4, 1 - 1e-4)
    op_logit = np.log(op / (1 - op))
    log_scales = np.log(np.maximum(np.asarray(scales, np.float32), 1e-8))

    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    arr = np.zeros(N, dtype=[(n, "<f4") for n in names])
    m = np.asarray(means, np.float32)
    for i, ax in enumerate("xyz"):
        arr[ax] = m[:, i]
    for i in range(3):
        arr[f"f_dc_{i}"] = f_dc[:, i]
        arr[f"scale_{i}"] = log_scales[:, i]
    arr["opacity"] = op_logit
    r = np.asarray(rotations, np.float32)
    for i in range(4):
        arr[f"rot_{i}"] = r[:, i]

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {N}\n"
        + "".join(f"property float {n}\n" for n in names)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(arr.tobytes())
    return path


def load_gaussians_ply(path: str):
    """Read back a 3DGS PLY (this writer's or any standard one with SH0
    only) -> dict(means, colors, scales, opacities, rotations)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode("ascii").splitlines()
        n = next(int(l.split()[-1]) for l in lines if l.startswith("element vertex"))
        names = [l.split()[-1] for l in lines if l.startswith("property float")]
        arr = np.frombuffer(f.read(), dtype=[(nm, "<f4") for nm in names], count=n)

    get = lambda *ns: np.stack([arr[x] for x in ns], -1)
    return {
        "means": get("x", "y", "z"),
        "colors": get("f_dc_0", "f_dc_1", "f_dc_2") * _SH_C0 + 0.5,
        "scales": np.exp(get("scale_0", "scale_1", "scale_2")),
        "opacities": 1.0 / (1.0 + np.exp(-arr["opacity"])),
        "rotations": get("rot_0", "rot_1", "rot_2", "rot_3"),
    }
