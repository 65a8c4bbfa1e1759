"""monodepth2's geometry and loss toolkit (counterpart of
``endosr/depth/layers.py``).

:func:`disp_to_depth`, axis-angle → SE(3) (:func:`rot_from_axisangle`,
:func:`get_translation_matrix`, :func:`transformation_from_parameters`),
pixel → point-cloud back-projection (:func:`backproject_depth`), 3-D →
pixel projection (:func:`project_3d`), the bilinear warp
(:func:`grid_sample`), the edge-aware smoothness (:func:`get_smooth_loss`)
and monodepth2's SSIM map (:func:`ssim_monodepth`).

Images and maps are NCHW tensors (the JAX twins take NHWC); pixel grids
are [B, H, W, 2] (x, y) in both. The warp is ``F.grid_sample`` with
bilinear taps, border padding and ``align_corners=False``, the semantics
the JAX twin's docstring names as its spec (``endosr/depth/layers.py:
113-118``); the JAX package computes all of this outside any Pallas
kernel, and so does the port (plain PyTorch, cuDNN for the pooling).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from endosr_torch.utils.device import device_constant

__all__ = [
    "disp_to_depth",
    "transformation_from_parameters",
    "rot_from_axisangle",
    "get_translation_matrix",
    "backproject_depth",
    "project_3d",
    "grid_sample",
    "get_smooth_loss",
    "ssim_monodepth",
]


def disp_to_depth(disp, min_depth: float = 0.1, max_depth: float = 100.0):
    """Sigmoid disparity → (scaled disparity, depth): the disparity mapped
    onto [1/max_depth, 1/min_depth] and its inverse. Takes a tensor or a
    numpy array."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [B, 1, 3] → rotation matrices [B, 4, 4] (Rodrigues)."""
    angle = torch.linalg.vector_norm(vec, dim=2, keepdim=True)
    axis = vec / (angle + 1e-7)

    ca = torch.cos(angle)[:, 0, 0]
    sa = torch.sin(angle)[:, 0, 0]
    c = 1 - ca
    x, y, z = axis[:, 0, 0], axis[:, 0, 1], axis[:, 0, 2]

    xs, ys, zs = x * sa, y * sa, z * sa
    xc, yc, zc = x * c, y * c, z * c
    xyc, yzc, zxc = x * yc, y * zc, z * xc

    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    return torch.stack([
        x * xc + ca, xyc - zs, zxc + ys, zeros,
        xyc + zs, y * yc + ca, yzc - xs, zeros,
        zxc - ys, yzc + xs, z * zc + ca, zeros,
        zeros, zeros, zeros, ones,
    ], dim=-1).reshape(-1, 4, 4)


def get_translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """[B, 3] or [B, 1, 3] translation → [B, 4, 4]."""
    t = t.reshape(-1, 3)
    eye = torch.eye(4, dtype=t.dtype, device=t.device).expand(
        t.shape[0], 4, 4)
    col = torch.cat([t, torch.ones_like(t[:, :1])], dim=1)
    return torch.cat([eye[:, :, :3], col[:, :, None]], dim=2)


def transformation_from_parameters(axisangle, translation,
                                   invert: bool = False):
    """(axis-angle, translation) → SE(3) [B, 4, 4]; ``invert`` gives the
    inverse transform (a source frame before the target)."""
    rot = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        rot = rot.transpose(1, 2)
        t = -t
    trans = get_translation_matrix(t)
    return torch.matmul(rot, trans) if invert else torch.matmul(trans, rot)


def _pix_grid(height: int, width: int) -> np.ndarray:
    """Homogeneous pixel grid [3, H·W] (x, y, 1)."""
    xx, yy = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    ones = np.ones_like(xx)
    return np.stack([xx.ravel(), yy.ravel(), ones.ravel()],
                    0).astype(np.float32)


def backproject_depth(depth: torch.Tensor,
                      inv_k: torch.Tensor) -> torch.Tensor:
    """Depth [B, 1, H, W] + K⁻¹ [B, 4, 4] → homogeneous camera points
    [B, 4, H·W]."""
    b, _, h, w = depth.shape
    pix = device_constant(_pix_grid, (h, w), depth.dtype, depth.device)
    cam = torch.matmul(inv_k[:, :3, :3], pix)
    cam = depth.reshape(b, 1, -1) * cam
    return torch.cat([cam, torch.ones_like(cam[:, :1])], dim=1)


def project_3d(points: torch.Tensor, k: torch.Tensor, t: torch.Tensor,
               height: int, width: int, eps: float = 1e-7) -> torch.Tensor:
    """Camera points [B, 4, H·W] → normalised pixel coordinates
    [B, H, W, 2] in [-1, 1]."""
    p = torch.matmul(k, t)[:, :3, :]
    cam = torch.matmul(p, points)
    pix = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    pix = pix.reshape(-1, 2, height, width).permute(0, 2, 3, 1)
    pix = pix / torch.tensor([width - 1, height - 1], dtype=pix.dtype,
                             device=pix.device)
    return (pix - 0.5) * 2.0


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of NCHW ``img`` at ``grid`` [B, Ho, Wo, 2]
    (normalised x, y in [-1, 1]) with border padding and
    ``align_corners=False`` → [B, C, Ho, Wo]."""
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                         align_corners=False)


def get_smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware disparity smoothness of NCHW ``disp`` weighted by NCHW
    ``img``'s gradients."""
    grad_disp_x = torch.abs(disp[:, :, :, :-1] - disp[:, :, :, 1:])
    grad_disp_y = torch.abs(disp[:, :, :-1, :] - disp[:, :, 1:, :])
    grad_img_x = torch.mean(torch.abs(img[:, :, :, :-1] - img[:, :, :, 1:]),
                            1, keepdim=True)
    grad_img_y = torch.mean(torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :]),
                            1, keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return grad_disp_x.mean() + grad_disp_y.mean()


def ssim_monodepth(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """monodepth2's SSIM dissimilarity map of two NCHW images:
    clamp((1 − SSIM) / 2, 0, 1), with 3×3 average pooling over
    reflection-padded inputs."""

    def pool(t):
        return F.avg_pool2d(F.pad(t, (1, 1, 1, 1), mode="reflect"), 3, 1)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x * x) - mu_x ** 2
    sigma_y = pool(y * y) - mu_y ** 2
    sigma_xy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0)
