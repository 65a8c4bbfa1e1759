"""Pixel losses (counterpart of ``endosr/losses/basic.py:25-57``).

L1, L2 and Charbonnier pixel losses and torch's SmoothL1 on tensors of any
shape; :func:`pixel_loss` picks one by the name ``train.pixel_criterion``
gives. The GAN losses and the gradient penalty wait for the GAN models.
"""

from __future__ import annotations

import torch

__all__ = ["l1_loss", "l2_loss", "charbonnier_loss", "smooth_l1_loss",
           "pixel_loss"]


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def l2_loss(pred, target):
    return (pred - target).square().mean()


def charbonnier_loss(pred, target, eps: float = 1e-6):
    """The sum (not the mean) of sqrt(diff² + eps), as the reference's
    ``CharbonnierLoss``."""
    return torch.sqrt((pred - target).square() + eps).sum()


def smooth_l1_loss(pred, target, beta: float = 1.0, reduction: str = "mean"):
    """torch ``nn.SmoothL1Loss``: 0.5·d²/β below β, d − 0.5·β above."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


_PIXEL = {"l1": l1_loss, "l2": l2_loss, "cb": charbonnier_loss}


def pixel_loss(kind: str):
    """The pixel criterion ``kind`` names (``l1``, ``l2`` or ``cb``)."""
    try:
        return _PIXEL[kind]
    except KeyError:
        raise NotImplementedError(f"Loss type [{kind}] is not recognized.")
