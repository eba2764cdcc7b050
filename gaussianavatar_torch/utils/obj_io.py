"""Minimal OBJ reader for UV-atlas template meshes (the port's copy of
`load_obj` from gaussianavatar_tpu/utils/obj_io.py): split v/vt topology."""

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
