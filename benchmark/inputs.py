"""Seeded inputs: smooth fields for frames and depth maps, made on the device.

A frame is a smooth random field (a coarse grid of values, bicubic
upsampled, plus a finer field at a sixth of its amplitude), normalized per
image to [0, 1]: like an endoscopy frame, it has large smooth regions and
some texture. Depth maps are smoother fields. Training pairs make the HR
frame first and the LR frame as its ``scale``×``scale`` box average, so LR
and GT agree as a dataset's pairs do.

The depth-bin masks are this file's own copy of the data loader's binning
(``depthFixedRange: false``): K equal-width bins between each image's own
minimum and maximum, bin i covering [min + i·Δ, min + (i + 1)·Δ), Δ =
(max − min)/K in float32; a value at the maximum falls in no bin.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["smooth_field", "depth_bins", "frames", "train_pairs"]


def smooth_field(gen, n, h, w, c, device, cells=8, detail=1 / 6):
    """[n, h, w, c] fp32 in [0, 1], each image and channel its own field."""
    coarse = torch.rand((n, c, cells + 1, cells + 1), generator=gen,
                        device=device)
    fine = torch.rand((n, c, max(2, h // 8), max(2, w // 8)), generator=gen,
                      device=device)
    x = (F.interpolate(coarse, size=(h, w), mode="bicubic",
                       align_corners=True)
         + detail * F.interpolate(fine, size=(h, w), mode="bilinear",
                                  align_corners=False))
    lo = x.amin(dim=(2, 3), keepdim=True)
    hi = x.amax(dim=(2, 3), keepdim=True)
    return _nhwc((x - lo) / (hi - lo).clamp_min(1e-6))


def _nhwc(x):
    """NCHW → an NHWC tensor with its own row-major strides, as a loader
    hands a batch over."""
    out = torch.empty((x.shape[0], x.shape[2], x.shape[3], x.shape[1]),
                      dtype=x.dtype, device=x.device)
    return out.copy_(x.permute(0, 2, 3, 1))


def depth_bins(depth, k: int):
    """Depth [..., H, W] → [..., H, W, K] 0/1 float32 masks of the image's
    own min/max bins."""
    depth = depth.float()
    lo = depth.amin(dim=(-2, -1), keepdim=True)[..., None]
    hi = depth.amax(dim=(-2, -1), keepdim=True)[..., None]
    step = (hi - lo) / np.float32(k)
    i = torch.arange(k, dtype=torch.float32, device=depth.device)
    d = depth[..., None]
    return ((d >= lo + step * i) & (d < lo + step * (i + 1.0))).float()


def frames(gen, n, hw, k, device):
    """(LR frames [n,H,W,3], depth [n,H,W,1], masks [n,H,W,K]), fp32."""
    h, w = hw
    lq = smooth_field(gen, n, h, w, 3, device)
    dep = smooth_field(gen, n, h, w, 1, device, cells=4, detail=1 / 12)
    return lq, dep, depth_bins(dep[..., 0], k)


def train_pairs(gen, n, hw, scale, k, device):
    """A training batch as the u8 loader hands it: LQ and GT uint8, depth
    fp32, masks uint8 0/1."""
    h, w = hw
    gt = smooth_field(gen, n, h * scale, w * scale, 3, device, cells=16)
    lq = _nhwc(F.avg_pool2d(gt.permute(0, 3, 1, 2), scale))
    dep = smooth_field(gen, n, h, w, 1, device, cells=4, detail=1 / 12)

    def u8(x):
        return (x * 255.0).round().clamp(0, 255).to(torch.uint8)

    return {"LQ": u8(lq), "GT": u8(gt), "Depth": dep,
            "DepthMaskList": depth_bins(dep[..., 0], k).to(torch.uint8)}
