"""Brute-force reference splatter (counterpart of
gaussianavatar_tpu/ops/rasterize_ref.py): the semantics lock.

Every pixel alpha-blends ALL gaussians in global depth order with the CUDA
rasterizer's gating rules: skip where power > 0, skip where alpha < 1/255,
clamp alpha at 0.99, and stop before the row that would take the
transmittance below 1e-4. The early-termination recurrence is written as
a cumulative product plus an OR-scan, so it is branchless. O(N * H * W):
tests and tiny scenes only.
"""

from __future__ import annotations

import torch

from gaussianavatar_torch.ops.projection import ProjectedGaussians

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def gate_terms(px, py, means2d, conics, opacities):
    """The exponent `power` and the clamped alpha of K gaussians at P pixels,
    each (..., K, P); arguments as `blend_pixels`."""
    dx = px[..., None, :] - means2d[..., 0:1]  # (..., K, P)
    dy = py[..., None, :] - means2d[..., 1:2]
    a, b, c = conics[..., 0:1], conics[..., 1:2], conics[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(opacities[..., None] * torch.exp(power), ALPHA_MAX)
    return power, alpha


def blend_pixels(
    px: torch.Tensor,          # (..., P) pixel x coords (float)
    py: torch.Tensor,          # (..., P) pixel y coords
    means2d: torch.Tensor,     # (..., K, 2) depth-ordered
    conics: torch.Tensor,      # (..., K, 3)
    colors: torch.Tensor,      # (..., K, 3)
    opacities: torch.Tensor,   # (..., K)
    active: torch.Tensor,      # (..., K) bool: gaussian participates at all
):
    """Blend K >= 1 depth-ordered gaussians into P pixels; leading dims batch.

    Returns (premult_color (..., P, 3), final_T (..., P), n_contrib (..., P)
    int32, done (..., P) bool — True where early termination fired). The
    caller adds final_T * bg. final_T is the product of the contributing
    (1 - alpha) factors in depth order, as the sequential blend computes it.
    """
    power, alpha = gate_terms(px, py, means2d, conics, opacities)
    gate = active[..., None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(gate, alpha, torch.zeros_like(alpha))

    one_minus = 1.0 - alpha
    # exclusive cumprod along the gaussian axis: T before gaussian i
    T_incl = torch.cumprod(one_minus, dim=-2)
    T_before = torch.cat([torch.ones_like(T_incl[..., :1, :]), T_incl[..., :-1, :]], dim=-2)

    test_T = T_before * one_minus
    trigger = gate & (test_T < T_EPS)
    done = torch.cumsum(trigger.to(torch.int32), dim=-2) > 0  # inclusive OR-scan
    contrib = gate & ~done

    weight = torch.where(contrib, alpha * T_before, torch.zeros_like(alpha))
    color = torch.einsum("...kp,...kc->...pc", weight, colors)

    # product of the contributing factors, multiplied in depth order
    final_T = torch.cumprod(torch.where(contrib, one_minus, torch.ones_like(one_minus)),
                            dim=-2)[..., -1, :]
    idx = torch.arange(1, alpha.shape[-2] + 1, dtype=torch.int32, device=px.device)[:, None]
    n_contrib = torch.where(contrib, idx, torch.zeros_like(idx)).amax(dim=-2)
    return color, final_T, n_contrib, done[..., -1, :]


def rasterize_brute(
    proj: ProjectedGaussians,   # one view: (N, ...) fields
    colors: torch.Tensor,
    opacities: torch.Tensor,
    bg: torch.Tensor,
    height: int,
    width: int,
    pixel_chunk: int = 4096,
) -> torch.Tensor:
    """Render (3, H, W) by brute force. Gaussians with radius <= 0 are skipped."""
    opacities = opacities.reshape(-1)
    key = torch.where(proj.radii > 0, proj.depths, torch.full_like(proj.depths, float("inf")))
    order = torch.argsort(key, stable=True)
    means2d = proj.means2d[order]
    conics = proj.conics[order]
    cols = colors[order]
    ops = opacities[order]
    active = proj.radii[order] > 0

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=means2d.dtype, device=means2d.device),
        torch.arange(width, dtype=means2d.dtype, device=means2d.device),
        indexing="ij",
    )
    px = xs.reshape(-1)
    py = ys.reshape(-1)
    out = []
    for s in range(0, px.shape[0], pixel_chunk):
        premult, final_T, _, _ = blend_pixels(
            px[s:s + pixel_chunk], py[s:s + pixel_chunk], means2d, conics, cols, ops, active)
        out.append(premult + final_T[:, None] * bg[None, :])
    img = torch.cat(out)
    return img.reshape(height, width, 3).permute(2, 0, 1)
