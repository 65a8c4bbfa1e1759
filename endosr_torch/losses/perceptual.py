"""VGG perceptual losses (counterpart of ``endosr/losses/perceptual.py``).

* :class:`VGGDepthLoss` — frozen multi-tap VGG features with the ImageNet
  normalization, a weighted L1 / L2 / Charbonnier per tap on the flattened
  activations (``endosr/losses/perceptual.py:45-68``).
* :class:`PerceptualLoss` — SRGAN's single-tap VGG19 layer-34 feature loss
  (``:71-83``), for the GAN models.

Images come in NHWC, as the generator gives them. The target's features
are computed under ``no_grad``; the networks are frozen (no gradient of
their own, ``eval()``) and belong to no model's parameters. Weights come
from ``vgg_weights_path`` (a torchvision ``.pth``; a missing file raises
``FileNotFoundError``) or, without one, from the port's seeded init
(``nn/vgg.py::VGGFeatures.init_``, seed ``seed``), whose numbers are not
the JAX package's flax init.
"""

from __future__ import annotations

import torch

from endosr_torch.losses.basic import pixel_loss
from endosr_torch.nn.vgg import VGGFeatures, load_vgg_state

__all__ = ["VGGDepthLoss", "PerceptualLoss", "frozen"]


def frozen(module, device):
    """``module`` on ``device`` in ``eval()``, its parameters without a
    gradient."""
    module = module.to(device).eval()
    for p in module.parameters():
        p.requires_grad_(False)
    return module


def _build_vgg(cfg, taps, max_layer, weights_path, seed, device):
    model = VGGFeatures(cfg, taps, max_layer, use_input_norm=True)
    if weights_path:
        load_vgg_state(model, weights_path)
    else:
        model.init_(torch.Generator().manual_seed(int(seed)))
    return frozen(model, device)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class VGGDepthLoss:
    """``opt``: the ``train.vgg_loss`` block (``vgg_layers``, ``vgg_weight``,
    ``vgg_criterion``, ``vgg_type``, ``vgg_weights_path``). Called on
    (SR, HR) NHWC images: (the weighted sum, the per-tap terms)."""

    def __init__(self, opt, device=None, seed: int = 0, mesh=None):
        self.layers = [int(x) for x in opt["vgg_layers"]]
        self.weights = [float(w) for w in opt["vgg_weight"]]
        self.cri = pixel_loss(opt["vgg_criterion"], mesh)
        self.model = _build_vgg(opt.get("vgg_type") or "vgg19", self.layers,
                                max(self.layers), opt.get("vgg_weights_path"),
                                seed, device)

    def __call__(self, preds, targs):
        pf = self.model(_nchw(preds))
        with torch.no_grad():
            tf = self.model(_nchw(targs))
        losses = [w * self.cri(p.reshape(p.shape[0], -1),
                               t.reshape(t.shape[0], -1))
                  for w, p, t in zip(self.weights, pf, tf)]
        return sum(losses), losses


class PerceptualLoss:
    """Single-tap VGG19 layer-``feature_layer`` feature loss (SRGAN's
    ``l_fea``) on NHWC images."""

    def __init__(self, criterion: str = "l1", weight: float = 1.0,
                 vgg_weights_path: str | None = None, feature_layer: int = 34,
                 device=None, seed: int = 0, mesh=None):
        self.cri = pixel_loss(criterion, mesh)
        self.weight = weight
        self.model = _build_vgg("vgg19", (feature_layer,), feature_layer,
                                vgg_weights_path, seed, device)

    def __call__(self, fake, real):
        f = self.model(_nchw(fake))[0]
        with torch.no_grad():
            r = self.model(_nchw(real))[0]
        return self.weight * self.cri(f, r)
