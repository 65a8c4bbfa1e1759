"""MATLAB bicubic resize in numpy, and torch-style interpolation on NHWC
tensors (counterpart of ``endosr/ops/resize.py``).

:func:`imresize_np` is MATLAB ``imresize`` (bicubic, antialiased when it
shrinks) as two dense matrix products ``M_H @ img @ M_W.T``, the symmetric
boundary folded into the matrices; the host data pipeline makes LR images
with it. :func:`interpolate_nearest` and :func:`interpolate_bilinear` are
torch ``F.interpolate`` on NHWC tensors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from endosr_torch.utils.device import device_constant

__all__ = ["imresize_np", "resize_matrix", "interpolate_nearest",
           "interpolate_bilinear"]


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB's bicubic interpolation kernel (a = -0.5)."""
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    f1 = (1.5 * absx3 - 2.5 * absx2 + 1.0) * (absx <= 1)
    f2 = (-0.5 * absx3 + 2.5 * absx2 - 4.0 * absx + 2.0) * ((absx > 1) & (absx <= 2))
    return f1 + f2


@functools.lru_cache(maxsize=256)
def resize_matrix(in_length: int, out_length: int, scale: float,
                  antialiasing: bool = True) -> np.ndarray:
    """Dense (out_length, in_length) resample matrix for one axis.

    Matches MATLAB's ``calculate_weights_indices`` semantics
    (including weight-row normalization, the zero-column trim, and symmetric
    boundary extension), with the boundary reflection folded into the matrix
    columns so that ``out = M @ in`` for a signal of length ``in_length``.
    """
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    # Trim all-zero first/last columns (as MATLAB's code narrows them).
    weights_zero_tmp = np.sum(weights == 0, axis=0)
    if not math.isclose(float(weights_zero_tmp[0]), 0, rel_tol=1e-6):
        indices = indices[:, 1:p - 1]
        weights = weights[:, 1:p - 1]
    if not math.isclose(float(weights_zero_tmp[-1]), 0, rel_tol=1e-6):
        indices = indices[:, 0:p - 2]
        weights = weights[:, 0:p - 2]

    # Fold symmetric boundary extension into a dense (out, in) matrix.
    idx = indices.astype(np.int64) - 1  # 0-based source index, may be out of range
    # Symmetric reflection (edge-inclusive): ..., 1, 0 | 0, 1, ..., n-1 | n-1, n-2, ...
    idx_reflected = idx.copy()
    neg = idx_reflected < 0
    idx_reflected[neg] = -idx_reflected[neg] - 1
    over = idx_reflected >= in_length
    idx_reflected[over] = 2 * in_length - 1 - idx_reflected[over]
    # One reflection is enough for every supported scale (kernel ≤ in_length);
    # clip defensively for degenerate tiny inputs.
    idx_reflected = np.clip(idx_reflected, 0, in_length - 1)

    mat = np.zeros((out_length, in_length), dtype=np.float64)
    rows = np.repeat(np.arange(out_length), idx_reflected.shape[1])
    np.add.at(mat, (rows, idx_reflected.ravel()), weights.ravel())
    return mat.astype(np.float32)


def _out_len(n: int, scale: float) -> int:
    return int(math.ceil(n * scale))


def imresize_np(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """MATLAB-bicubic resize of an HWC (or HW) float array by ``scale``
    → float32."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    in_h, in_w = img.shape[0], img.shape[1]
    m_h = resize_matrix(in_h, _out_len(in_h, scale), scale, antialiasing)
    m_w = resize_matrix(in_w, _out_len(in_w, scale), scale, antialiasing)
    out = np.einsum("oh,hwc->owc", m_h, img.astype(np.float32))
    out = np.einsum("pw,owc->opc", m_w, out)
    out = out.astype(np.float32)
    return out[..., 0] if squeeze else out


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
