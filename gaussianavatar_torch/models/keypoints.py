"""Vertex-anchored extra keypoints for SMPL-family models (counterpart of
gaussianavatar_tpu/models/keypoints.py, as far as `body.forward` needs it):
a handful of mesh vertices (nose, eyes, ears, toes, heels, fingertips) are
appended to the regressed joints of the official mesh topologies."""

from __future__ import annotations

import numpy as np
import torch

# vertex index -> keypoint tables for the official topologies
VERTEX_IDS = {
    "smpl": {
        "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
        "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
        "rpinky": 6133, "lthumb": 2746, "lindex": 2319, "lmiddle": 2445,
        "lring": 2556, "lpinky": 2673,
        "LBigToe": 3216, "LSmallToe": 3226, "LHeel": 3387,
        "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    },
    "smplx": {
        "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
        "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905,
        "rpinky": 8022, "lthumb": 5361, "lindex": 4933, "lmiddle": 5058,
        "lring": 5169, "lpinky": 5286,
        "LBigToe": 5770, "LSmallToe": 5780, "LHeel": 8846,
        "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    },
}

# official vertex counts: the loaders attach the table only to meshes with
# the topology it indexes into
OFFICIAL_NUM_VERTS = {"smpl": 6890, "smplx": 10475}

_FACE_KEYS = ["nose", "reye", "leye", "rear", "lear"]
_FEET_KEYS = ["LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel"]
_TIP_KEYS = ["thumb", "index", "middle", "ring", "pinky"]


def extra_joint_ids(model_type: str) -> np.ndarray:
    """Static vertex-index table: face keypoints, then feet, then l/r
    fingertips."""
    table = VERTEX_IDS[model_type]
    idxs = [table[k] for k in _FACE_KEYS + _FEET_KEYS]
    idxs += [table[h + t] for h in ("l", "r") for t in _TIP_KEYS]
    return np.array(idxs, dtype=np.int64)


def select_extra_joints(vertices: torch.Tensor, joints: torch.Tensor,
                        ids) -> torch.Tensor:
    """Append vertex-anchored keypoints: (B, V, 3), (B, J, 3) -> (B, J+E, 3).
    `ids` is the (E,) table, best as a tensor on the vertices' device (the
    body model keeps it so: no host-to-device copy in the train step)."""
    extra = vertices[:, torch.as_tensor(ids, device=vertices.device)]
    return torch.cat([joints, extra], dim=1)
