"""Depth-range mask binning (counterpart of ``endosr/ops/masks.py``).

A depth map becomes K binary masks, one per equal-width bin; bin i covers
[min + i·Δ, min + (i+1)·Δ) with Δ = (max − min)/K. ``fixed_range=True``
uses [0, 1], ``False`` the image's own min/max (values ≥ max fall in no
bin). Bin edges are float32, as in the reference data loader.
:func:`pool_mask_np` is the host-side mask resize of exact bucketed eval.
"""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.utils.device import device_constant

__all__ = ["depth_masks_np", "depth_masks", "pool_mask_np"]


def _lerp_resize_axis(m: np.ndarray, out_len: int, axis: int) -> np.ndarray:
    """One axis of a bilinear (align_corners) resize as an explicit two-term
    fp32 lerp, arithmetic-identical to the interpolation-matrix product of
    ``ops.resize.interpolate_bilinear`` (a two-nonzero row dot does not
    depend on summation order)."""
    in_len = m.shape[axis]
    if in_len == out_len:
        return m
    if out_len == 1:
        return np.take(m, [0], axis=axis)
    src = np.arange(out_len, dtype=np.float64) * (in_len - 1) / (out_len - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_len - 1)
    f = (src - lo).astype(np.float32)
    shape = [1] * m.ndim
    shape[axis] = out_len
    f = f.reshape(shape)
    return ((np.float32(1.0) - f) * np.take(m, lo, axis=axis)
            + f * np.take(m, hi, axis=axis))


def pool_mask_np(masks: np.ndarray, out_hw, pad_hw=None) -> np.ndarray:
    """Host twin of the mask resize inside ``region_wise_avg_pooling``.

    ``masks`` [B,h,w,K] (binary, unpadded input resolution) are resized to
    ``out_hw``, the VALID size of the encoder latent, with the same bilinear
    align_corners interpolation and ≥ 0.5 binarization the device applies,
    then zero-padded to ``pad_hw`` (the padded latent shape), so the padded
    pooling excludes every latent pixel outside the image and its
    denominator equals the unpadded run's."""
    m = masks.astype(np.float32)
    if (m.shape[1], m.shape[2]) != tuple(out_hw):
        m = _lerp_resize_axis(m, out_hw[0], 1)
        m = _lerp_resize_axis(m, out_hw[1], 2)
        m = (m >= 0.5).astype(np.float32)
    if pad_hw is not None:
        ph, pw = pad_hw[0] - m.shape[1], pad_hw[1] - m.shape[2]
        if ph or pw:
            m = np.pad(m, ((0, 0), (0, ph), (0, pw), (0, 0)))
    return m


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
