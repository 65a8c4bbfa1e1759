"""Depth-range mask binning (counterpart of ``endosr/ops/masks.py``).

A depth map becomes K binary masks, one per equal-width bin; bin i covers
[min + i·Δ, min + (i+1)·Δ) with Δ = (max − min)/K. ``fixed_range=True``
uses [0, 1], ``False`` the image's own min/max (values ≥ max fall in no
bin). Bin edges are float32, as in the reference data loader.
"""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.utils.device import device_constant

__all__ = ["depth_masks_np", "depth_masks"]


def depth_masks_np(depth: np.ndarray, fixed_range: bool = True,
                   num_masks: int = 10) -> np.ndarray:
    """HW depth map → (H, W, K) float32 binary masks."""
    depth = np.squeeze(depth).astype(np.float32)
    i = np.arange(num_masks)
    if fixed_range:
        interval = 1.0 / num_masks
        edges_lo = (interval * i).astype(np.float32)
        edges_hi = (interval * (i + 1)).astype(np.float32)
    else:
        min_val = depth.min()
        max_val = depth.max()
        interval = ((max_val - min_val) / np.float32(num_masks)).astype(np.float32)
        edges_lo = min_val + interval * i.astype(np.float32)
        edges_hi = min_val + interval * (i + 1).astype(np.float32)
    d = depth[..., None]
    return ((d >= edges_lo) & (d < edges_hi)).astype(np.float32)


def _fixed_edges(num_masks):
    """[2, K] float32 lower/upper bin edges of the fixed [0, 1] range."""
    interval = np.float64(1.0) / num_masks
    return np.stack([(interval * np.arange(num_masks)).astype(np.float32),
                     (interval * np.arange(1, num_masks + 1)).astype(np.float32)])


def depth_masks(depth: torch.Tensor, fixed_range: bool = True,
                num_masks: int = 10) -> torch.Tensor:
    """Tensor version: depth (..., H, W) → (..., H, W, K) float32 masks,
    computed on depth's device."""
    depth = depth.float()
    if fixed_range:
        lo, hi = device_constant(_fixed_edges, (num_masks,), torch.float32,
                                 depth.device)
    else:
        i = torch.arange(num_masks, dtype=torch.float32, device=depth.device)
        min_val = depth.amin(dim=(-2, -1), keepdim=True)[..., None]
        max_val = depth.amax(dim=(-2, -1), keepdim=True)[..., None]
        interval = (max_val - min_val) / np.float32(num_masks)
        lo = min_val + interval * i
        hi = min_val + interval * (i + 1.0)
    d = depth[..., None]
    return ((d >= lo) & (d < hi)).float()
