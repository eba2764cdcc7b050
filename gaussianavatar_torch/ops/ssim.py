"""Image losses (counterpart of gaussianavatar_tpu/ops/ssim.py): SSIM with
an 11x11 Gaussian window (sigma 1.5) applied as two separable depthwise
convolutions with zero same-padding, C1 = 0.01^2, C2 = 0.03^2, mean over
every pixel; per-image PSNR; L1 and L2 (the mean squared error). All in float32 (TF32 is off for the whole
port, see gaussianavatar_torch/__init__.py): the sigma terms are
E[x^2] - mu^2 cancellations that a lower-precision convolution spoils.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window(window_size: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The 1-D window on `device`, made once (a CUDA graph of the train step
    cannot capture the host-to-device copy); never written."""
    return torch.as_tensor(_gaussian_1d(window_size, 1.5), dtype=dtype, device=device)


def _depthwise_filter(img: torch.Tensor, g1d: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, C, H, W) convolved with outer(g, g): along H, then along W."""
    C, k = img.shape[1], g1d.shape[0]
    x = F.conv2d(img, g1d.reshape(1, 1, k, 1).expand(C, 1, k, 1), padding=(pad, 0), groups=C)
    return F.conv2d(x, g1d.reshape(1, 1, 1, k).expand(C, 1, 1, k), padding=(0, pad), groups=C)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """Structural similarity of two (B, C, H, W) (or (C, H, W)) batches."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    g1d = _window(window_size, img1.dtype, img1.device)
    C = img1.shape[1]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=1)
    f = _depthwise_filter(stacked, g1d, window_size // 2)
    mu1, mu2 = f[:, :C], f[:, C:2 * C]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = f[:, 2 * C:3 * C] - mu1_sq
    sigma2_sq = f[:, 3 * C:4 * C] - mu2_sq
    sigma12 = f[:, 4 * C:] - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over flattened pixels -> (B, 1)."""
    b = img1.shape[0] if img1.dim() == 4 else 1
    mse = ((img1.reshape(b, -1) - img2.reshape(b, -1)) ** 2).mean(dim=1, keepdim=True)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def l1_loss(network_output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (network_output - gt).abs().mean()


def l2_loss(network_output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((network_output - gt) ** 2).mean()
