"""Optical-flow warping and the DUF Gaussian downsampler (counterpart of
``endosr/ops/warp.py``).

:func:`flow_warp` builds the identity grid, adds the flow, normalises by
2·v / max(dim − 1, 1) − 1 and samples bilinearly through
``depth/layers.py::grid_sample`` (border padding, ``align_corners=False``,
as the JAX twin); :func:`duf_downsample` is a 13×13 Gaussian blur of each
channel (a depthwise conv) with ×scale strided sampling of video frames.
Both take NHWC tensors, as the JAX twins do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from endosr_torch.depth.layers import grid_sample
from endosr_torch.utils.device import device_constant

__all__ = ["flow_warp", "duf_downsample"]


def _identity_grid(h: int, w: int) -> np.ndarray:
    xx, yy = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    return np.stack([xx, yy], -1).astype(np.float32)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp NHWC ``x`` by a per-pixel flow [B, H, W, 2] (x then y
    displacement) → NHWC."""
    _, h, w, _ = x.shape
    grid = device_constant(_identity_grid, (h, w), torch.float32, x.device)
    vgrid = grid[None] + flow
    gx = 2.0 * vgrid[..., 0] / max(w - 1, 1) - 1.0
    gy = 2.0 * vgrid[..., 1] / max(h - 1, 1) - 1.0
    out = grid_sample(x.permute(0, 3, 1, 2), torch.stack([gx, gy], dim=-1))
    return out.permute(0, 2, 3, 1)


def _gkern(kernlen: int = 13, nsig: float = 1.6) -> np.ndarray:
    """A Gaussian-filtered delta (``scipy.ndimage.gaussian_filter`` on a
    centred dirac)."""
    from scipy import ndimage

    inp = np.zeros((kernlen, kernlen))
    inp[kernlen // 2, kernlen // 2] = 1
    return ndimage.gaussian_filter(inp, nsig)


def _depthwise_kernel(scale: int, c: int) -> np.ndarray:
    k = _gkern(13, 0.4 * scale).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(k, (c, 1, 13, 13)))


def duf_downsample(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """[B, T, H, W, C] frames → Gaussian-blurred, ×scale-strided frames
    [B, T, H', W', C]."""
    if scale not in (2, 3, 4):
        raise ValueError(f"Scale [{scale}] is not supported")
    b, t, h, w, c = x.shape
    xf = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    pad = 6 + scale * 2
    r_h = (3 - h % 3) % 3 if scale == 3 else 0
    r_w = (3 - w % 3) % 3 if scale == 3 else 0
    xf = F.pad(xf, (pad, pad + r_w, pad, pad + r_h), mode="reflect")
    kern = device_constant(_depthwise_kernel, (scale, c), xf.dtype,
                           xf.device)
    y = F.conv2d(xf, kern, stride=scale, groups=c)
    y = y[:, :, 2:-2, 2:-2]
    return y.permute(0, 2, 3, 1).reshape(b, t, y.shape[2], y.shape[3], c)
