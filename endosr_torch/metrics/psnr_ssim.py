"""SSIM on tensors (counterpart of ``ssim_jax``, ``endosr/metrics/
psnr_ssim.py:107``): the pytorch_ssim protocol the training loss uses, an
11×11 Gaussian window (σ 1.5) as a per-channel conv with zero padding,
NHWC inputs in [0, 1], one value per image. PSNR and the host-side
metrics of evaluation are still to be ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from endosr_torch.utils.device import device_constant

__all__ = ["gaussian_window", "ssim"]


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The [size, size] outer product of a normalised 1-D Gaussian (as
    ``cv2.getGaussianKernel``)."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    return np.outer(k, k)


def _window(size: int, c: int) -> np.ndarray:
    return np.tile(gaussian_window(size, 1.5)[None, None], (c, 1, 1, 1))


def ssim(img1, img2, window_size: int = 11):
    """SSIM of NHWC ``img1``, ``img2`` → [B], in fp32."""
    c = img1.shape[-1]
    win = device_constant(_window, (window_size, c), torch.float32,
                          img1.device)

    def blur(x):
        return F.conv2d(x.permute(0, 3, 1, 2), win,
                        padding=window_size // 2, groups=c)

    img1, img2 = img1.float(), img2.float()
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = blur(img1 ** 2) - mu1_sq
    sigma2_sq = blur(img2 ** 2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean(dim=(1, 2, 3))
