"""SSIM loss term (counterpart of ``endosr/losses/ssim.py:16-32``)."""

from __future__ import annotations

from endosr_torch.metrics.psnr_ssim import ssim

__all__ = ["ssim_value", "ssim_loss"]


def ssim_value(sr, hr, window_size: int = 11):
    """Mean SSIM over the batch."""
    return ssim(sr, hr, window_size).mean()


def ssim_loss(sr, hr, weight: float = 1.0, window_size: int = 11,
              one_minus: bool = False):
    """``weight·SSIM``, added to the total as the reference adds it (which
    rewards dissimilarity; every shipped recipe leaves it off), or with
    ``one_minus`` the usual ``weight·(1 − SSIM)``."""
    s = ssim_value(sr, hr, window_size)
    return weight * (1.0 - s) if one_minus else weight * s
