"""PSNR and SSIM (counterpart of ``endosr/metrics/psnr_ssim.py``).

:func:`calculate_psnr` and :func:`calculate_ssim` score evaluation images
in numpy float64 by the MATLAB protocol: inputs in [0, 255], an 11×11
Gaussian window (σ 1.5), the valid region only. :func:`ssim` is the
pytorch_ssim protocol on tensors that the training loss and the training
loop's validation use (``ssim_jax`` in JAX): NHWC inputs in [0, 1], the
window as a per-channel conv with zero padding, one value per image.
"""

from __future__ import annotations

import math

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view
import torch
import torch.nn.functional as F

from endosr_torch.utils.device import device_constant

__all__ = ["calculate_psnr", "calculate_ssim", "gaussian_window", "ssim"]


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The [size, size] outer product of a normalised 1-D Gaussian (as
    ``cv2.getGaussianKernel``)."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    return np.outer(k, k)


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR of two [0, 255] images (any shape)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _filter2d_valid(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Per-channel 2-D correlation over the valid region."""
    kh, kw = window.shape
    if img.ndim == 2:
        return np.einsum("hwkl,kl->hw", sliding_window_view(img, (kh, kw)),
                         window)
    patches = sliding_window_view(img, (kh, kw), axis=(0, 1))
    return np.einsum("hwckl,kl->hwc", patches, window)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = gaussian_window(11, 1.5)

    mu1 = _filter2d_valid(img1, window)
    mu2 = _filter2d_valid(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter2d_valid(img1 ** 2, window) - mu1_sq
    sigma2_sq = _filter2d_valid(img2 ** 2, window) - mu2_sq
    sigma12 = _filter2d_valid(img1 * img2, window) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM of two [0, 255] images (HW, HW1 or HWC; three channels are
    averaged in one map, as MATLAB's scorer does)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2 or (img1.ndim == 3 and img1.shape[2] == 3):
        return _ssim_single(img1, img2)
    if img1.ndim == 3 and img1.shape[2] == 1:
        return _ssim_single(img1[..., 0], img2[..., 0])
    raise ValueError("Wrong input image dimensions.")


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
