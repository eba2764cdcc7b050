"""Minimal OBJ and PLY I/O (the port's copy of
gaussianavatar_tpu/utils/obj_io.py): `load_obj` reads UV-atlas template
meshes with split v/vt topology, `save_obj` writes a mesh and
`save_ply_points` an ASCII point cloud, byte for byte as the JAX package
writes them."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ObjMesh(NamedTuple):
    verts: np.ndarray      # (V, 3)
    uvs: np.ndarray        # (VT, 2) may be empty
    faces_v: np.ndarray    # (F, 3)
    faces_vt: np.ndarray   # (F, 3) may be empty


def load_obj(path: str) -> ObjMesh:
    verts, uvs, faces_v, faces_vt = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                fv, fvt = [], []
                for vert in parts[1:4]:
                    comps = vert.split("/")
                    fv.append(int(comps[0]) - 1)
                    if len(comps) > 1 and comps[1]:
                        fvt.append(int(comps[1]) - 1)
                faces_v.append(fv)
                if fvt:
                    faces_vt.append(fvt)
    return ObjMesh(
        verts=np.asarray(verts, np.float32),
        uvs=np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32),
        faces_v=np.asarray(faces_v, np.int64),
        faces_vt=np.asarray(faces_vt, np.int64) if faces_vt else np.zeros((0, 3), np.int64),
    )


def save_obj(path: str, verts: np.ndarray, faces_v: np.ndarray,
             uvs: np.ndarray = None, faces_vt: np.ndarray = None):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if uvs is not None:
            for t in uvs:
                f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        if uvs is not None and faces_vt is not None:
            for fv, ft in zip(faces_v, faces_vt):
                f.write(
                    f"f {fv[0]+1}/{ft[0]+1} {fv[1]+1}/{ft[1]+1} {fv[2]+1}/{ft[2]+1}\n"
                )
        else:
            for fv in faces_v:
                f.write(f"f {fv[0]+1} {fv[1]+1} {fv[2]+1}\n")


def save_ply_points(path: str, points: np.ndarray):
    """ASCII PLY point cloud (the reference's debug dumps of the posed
    points during training)."""
    points = np.asarray(points)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\nend_header\n"
        )
        for p in points:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
