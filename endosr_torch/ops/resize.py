"""torch-style interpolation on NHWC tensors (counterpart of the
``interpolate_*`` half of ``endosr/ops/resize.py``)."""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.utils.device import device_constant

__all__ = ["interpolate_nearest", "interpolate_bilinear"]


def _nearest_index(out_len: int, in_len: int) -> np.ndarray:
    # torch F.interpolate(mode='nearest'): src = floor(dst · in/out)
    return np.minimum(
        (np.arange(out_len, dtype=np.float64) * (in_len / out_len)).astype(np.int64),
        in_len - 1)


def interpolate_nearest(x, size):
    """torch ``F.interpolate(mode='nearest')`` for NHWC tensors."""
    in_h, in_w = x.shape[1], x.shape[2]
    if (in_h, in_w) == tuple(size):
        return x
    hi = device_constant(_nearest_index, (size[0], in_h), torch.int64, x.device)
    wi = device_constant(_nearest_index, (size[1], in_w), torch.int64, x.device)
    return x.index_select(1, hi).index_select(2, wi)


def _bilinear_matrix(in_len: int, out_len: int, align_corners: bool) -> np.ndarray:
    """Dense 1-D torch-bilinear interpolation matrix (out_len, in_len)."""
    mat = np.zeros((out_len, in_len), dtype=np.float32)
    if out_len == 1:
        if align_corners or in_len == 1:
            mat[0, 0] = 1.0
            return mat
        src = np.array([0.5 * in_len - 0.5])
    elif align_corners:
        src = np.arange(out_len, dtype=np.float64) * (in_len - 1) / (out_len - 1)
    else:
        src = (np.arange(out_len, dtype=np.float64) + 0.5) * (in_len / out_len) - 0.5
        src = np.clip(src, 0, in_len - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_len - 1)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(out_len)
    np.add.at(mat, (rows, lo), 1.0 - frac)
    np.add.at(mat, (rows, hi), frac)
    return mat


def interpolate_bilinear(x, size, align_corners: bool = False):
    """torch ``F.interpolate(mode='bilinear')`` for NHWC tensors, as two
    fp32 matrix products (the same formulation as the JAX twin)."""
    in_h, in_w = x.shape[1], x.shape[2]
    if (in_h, in_w) == tuple(size):
        return x
    m_h = device_constant(_bilinear_matrix, (in_h, size[0], align_corners),
                          torch.float32, x.device)
    m_w = device_constant(_bilinear_matrix, (in_w, size[1], align_corners),
                          torch.float32, x.device)
    y = torch.einsum("oh,bhwc->bowc", m_h, x.float())
    y = torch.einsum("pw,bowc->bopc", m_w, y)
    return y.to(x.dtype)
