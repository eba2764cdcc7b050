"""gaussianavatar_torch — the PyTorch/CUDA port of gaussianavatar_tpu for one
NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(`ops/`, `models/`, `engine/`, `data/`, `utils/`) and imports nothing of it.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package becomes
a kernel written by hand for Hopper (`csrc/`), each beside a plain-PyTorch
version that the CPU tests use. Entry points run on `device="cuda"` unless
the caller passes `device="cpu"`.
"""

import torch

__version__ = "0.1.0"

# Precision, set once for the whole port. The JAX package runs LBS, skinning
# and projection at Precision.HIGHEST (models/avatar.py, ops/projection.py)
# and its decoder convolutions in f32. On the card PyTorch would run f32
# convolutions through cuDNN in TF32 (~3 decimal digits), so both TF32
# switches are pinned off: f32 means f32 everywhere in the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
