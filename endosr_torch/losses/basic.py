"""Pixel and adversarial losses (counterpart of ``endosr/losses/basic.py``).

L1, L2 and Charbonnier pixel losses and torch's SmoothL1 on tensors of any
shape; :func:`pixel_loss` picks one by the name ``train.pixel_criterion``
gives. :func:`gan_loss` is the GAN models' criterion (``gan`` / ``ragan``:
BCE with logits, ``lsgan``: MSE, ``wgan-gp``: the signed mean) and
:func:`gradient_penalty` WGAN-GP's penalty on random interpolates.
"""

from __future__ import annotations

import torch

from endosr_torch.parallel.mesh import world_size

__all__ = ["l1_loss", "l2_loss", "charbonnier_loss", "smooth_l1_loss",
           "pixel_loss", "bce_with_logits", "gan_loss", "gradient_penalty"]


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


def pixel_loss(kind: str, mesh=None):
    """The pixel criterion ``kind`` names (``l1``, ``l2`` or ``cb``). Under
    data parallelism (``mesh``, ``parallel/mesh.py``) the ``cb`` sum is
    ``world`` × this rank's sum, so that the ranks' mean is the global
    batch's sum; the means are this rank's means."""
    try:
        fn = _PIXEL[kind]
    except KeyError:
        raise NotImplementedError(f"Loss type [{kind}] is not recognized.")
    n = world_size(mesh)
    if kind == "cb" and n > 1:
        return lambda pred, target: n * charbonnier_loss(pred, target)
    return fn


def bce_with_logits(logits, targets):
    """mean(max(l, 0) − l·t + log1p(exp(−|l|))), the JAX package's form."""
    return torch.mean(torch.clamp(logits, min=0) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def gan_loss(gan_type: str, pred, target_is_real: bool,
             real_label_val: float = 1.0, fake_label_val: float = 0.0):
    """The reference's ``GANLoss`` of logits ``pred`` against the real or
    the fake label: ``gan`` / ``ragan`` BCE with logits, ``lsgan`` MSE,
    ``wgan-gp`` −mean (real) or mean (fake); another type raises."""
    if gan_type == "wgan-gp":
        return -pred.mean() if target_is_real else pred.mean()
    label = real_label_val if target_is_real else fake_label_val
    if gan_type == "lsgan":
        return (pred - label).square().mean()
    if gan_type in ("gan", "ragan"):
        return bce_with_logits(pred, label)
    raise NotImplementedError(f"GAN type [{gan_type}] is not found")


def gradient_penalty(disc_fn, real, fake, generator=None, alpha=None):
    """WGAN-GP's E[(‖∇D(x̂)‖₂ − 1)²] at x̂ = real + α·(fake − real), one
    α ~ U[0, 1) a sample drawn from ``generator`` (on its device), or the
    given ``alpha`` (broadcastable to ``real``). The gradient of D is kept
    in the graph, so the penalty has a gradient of its own; 1e-12 under
    the square root, as in JAX."""
    b = real.shape[0]
    if alpha is None:
        shape = (b,) + (1,) * (real.ndim - 1)
        dev = generator.device if generator is not None else real.device
        alpha = torch.rand(shape, generator=generator, device=dev)
    interp = real + alpha.to(real) * (fake - real)
    if not interp.requires_grad:
        interp.requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_fn(interp).sum(), interp,
                                   create_graph=True)
    norm = torch.sqrt(grads.reshape(b, -1).square().sum(1) + 1e-12)
    return (norm - 1.0).square().mean()
