"""NeRF-style positional encoding (counterpart of
gaussianavatar_tpu/ops/embedder.py): the POP decoder encodes its uv query
coordinates with it under `--pos_encoding 1`."""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def get_embedder(
    multires: int,
    input_dims: int = 3,
    include_input: bool = True,
    log_sampling: bool = True,
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """-> (embed_fn, out_dim): x (..., d) -> (..., out_dim) with
    [x, sin(f_0 x), cos(f_0 x), ..., sin(f_{m-1} x), cos(f_{m-1} x)], the
    frequencies 2^0..2^{m-1} spaced in the exponent (log_sampling) or
    linearly. `multires <= 0` is the identity."""
    if multires <= 0:
        return (lambda x: x), input_dims

    lo, hi = (0.0, multires - 1.0) if log_sampling else (2.0**0, 2.0 ** (multires - 1))
    # jnp.linspace's float32 arithmetic: lo * (1 - s) + hi * s, s = i / (m - 1),
    # the last point hi itself
    s = torch.arange(multires, dtype=torch.float32) / max(multires - 1, 1)
    freqs = lo * (1 - s) + hi * s
    freqs[-1] = hi
    if log_sampling:
        freqs = 2.0 ** freqs
    freqs = [float(f) for f in freqs]
    out_dim = input_dims * (2 * multires + (1 if include_input else 0))

    def embed(x: torch.Tensor) -> torch.Tensor:
        parts = [x] if include_input else []
        for f in freqs:
            parts.append(torch.sin(x * f))
            parts.append(torch.cos(x * f))
        return torch.cat(parts, dim=-1)

    return embed, out_dim
