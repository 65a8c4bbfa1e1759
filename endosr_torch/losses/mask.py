"""Depth-mask losses (counterpart of ``endosr/losses/mask.py:30-118``).

:func:`mask_loss` masks both images with one depth bin's mask (the bin
drawn by the caller), nearest-resized to the SR size; SmoothL1 is summed
and divided by the mask's area. :func:`dynamic_weight_mask_loss` is the
paper's dynamic depth-aware loss: the per-bin masked losses of all K bins
weighted by the softmax of a trainable K-vector that the generator's
optimizer learns with it. Masks are [B,h,w,K], images [B,H,W,C].

Under data parallelism (``mesh``, ``parallel/mesh.py``) each rank holds a
part of the batch, and the losses are the global batch's, as JAX's one
program over the mesh computes them: a ratio's numerator and its mask
area are summed over the ranks (:func:`~endosr_torch.parallel.mesh.global_sum`,
through which the gradient flows) before the division, so every rank
computes the same global value; a sum over samples that is no ratio
(``cb``) is ``world`` × this rank's, whose mean over the ranks is the
global sum.
"""

from __future__ import annotations

import torch

from endosr_torch.losses.basic import (charbonnier_loss, l1_loss, l2_loss,
                                       smooth_l1_loss)
from endosr_torch.ops.resize import interpolate_nearest
from endosr_torch.parallel.mesh import global_sum, world_size

__all__ = ["per_bin_masked_loss", "mask_loss", "dynamic_weight_mask_loss"]


def per_bin_masked_loss(sr, hr, mask_list, criterion: str = "smoothl1",
                        mesh=None):
    """The per-bin masked loss vector [K].

    ``smoothl1``: Σ(loss·mask) / Σ(mask·C) per bin. The mean criteria
    (``l1``, ``l2``) divide by the image's size, ``cb`` sums over every
    pixel (√ε where the mask is 0), as the reference's loop over masked
    images does. When the mask's size divides the image's, nearest
    upsampling is block-constant and the sums are taken over block sums
    of the loss at the mask's resolution (exact, without the upsampled
    [B,H,W,K] stack); otherwise the masks are resized. With a ``mesh`` the
    per-bin sums and the areas are the global batch's."""
    b, hh, ww, c = sr.shape
    hm, wm = mask_list.shape[1], mask_list.shape[2]
    block = hh % hm == 0 and ww % wm == 0
    fh, fw = (hh // hm, ww // wm) if block else (1, 1)
    masks = mask_list if block else interpolate_nearest(mask_list, (hh, ww))

    def per_bin_sum(elem):
        """Σ elem·mask_k per bin; elem [B,H,W], already summed over C."""
        if block:
            elem = elem.reshape(b, hm, fh, wm, fw).sum(dim=(2, 4))
        return global_sum(torch.einsum("bhw,bhwk->k", elem, masks), mesh)

    diff = sr - hr
    if criterion == "smoothl1":
        ad = diff.abs()
        elem = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum(dim=-1)
        area = global_sum(masks.sum(dim=(0, 1, 2)), mesh) * (fh * fw)
        return per_bin_sum(elem) / (area * c)
    n = sr.numel() * world_size(mesh)
    if criterion == "l1":
        return per_bin_sum(diff.abs().sum(dim=-1)) / n
    if criterion == "l2":
        return per_bin_sum(diff.square().sum(dim=-1)) / n
    if criterion == "cb":
        eps = 1e-6
        inside = per_bin_sum((torch.sqrt(diff.square() + eps)
                              - eps ** 0.5).sum(dim=-1))
        return inside + n * eps ** 0.5
    raise NotImplementedError(
        f"Loss type [{criterion}] for depth loss is not recognized.")


def mask_loss(sr, hr, mask_list, bin_index, criterion: str = "smoothl1",
              weight: float = 1.0, mesh=None):
    """The mask loss of bin ``bin_index`` (an int or a 0-d tensor): its
    mask is selected, then nearest-resized to the SR size. With a ``mesh``
    (every rank draws the same bin) the global batch's."""
    m = mask_list.index_select(-1, torch.as_tensor(bin_index).reshape(1)
                               .to(mask_list.device))
    m = interpolate_nearest(m, (sr.shape[1], sr.shape[2]))
    masked_sr, masked_hr = sr * m, hr * m
    if criterion == "smoothl1":
        loss = global_sum(smooth_l1_loss(masked_sr, masked_hr,
                                         reduction="sum"), mesh)
        return loss / (global_sum(m.sum(), mesh) * sr.shape[-1]) * weight
    crit = {"l1": l1_loss, "l2": l2_loss, "cb": charbonnier_loss}[criterion]
    scale = world_size(mesh) if criterion == "cb" else 1
    return weight * crit(masked_sr, masked_hr) * scale


def dynamic_weight_mask_loss(sr, hr, mask_list, trainable_weight,
                             criterion: str = "smoothl1", weight: float = 1.0,
                             mesh=None):
    """(per-bin losses [K], weighted per-bin [K], total, softmax weights
    [K]); the softmax of ``trainable_weight`` is taken in fp32. With a
    ``mesh`` the per-bin losses are the global batch's."""
    losses = per_bin_masked_loss(sr, hr, mask_list, criterion, mesh)
    w = torch.softmax(trainable_weight.float(), dim=0)
    weighted = w * losses
    return losses, weighted, weighted.sum() * weight, w
