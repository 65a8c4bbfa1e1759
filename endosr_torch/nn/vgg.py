"""VGG feature stacks for the perceptual losses (counterpart of
``endosr/nn/vgg.py``).

* :class:`VGGFeatures` — torchvision's VGG ``features`` trunk, its convs
  named by their ``features.N`` index so that a torchvision ``vgg19-*.pth``
  loads as it is; returns the activations at the requested taps.
* :class:`VGGFeatureExtractor` — SRGAN's perceptual extractor: VGG19 up to
  layer 34 with the ImageNet input normalization.

NCHW, plain ``torch.nn`` (cuDNN on the card; the JAX package computes VGG
outside any Pallas kernel). Weights come from a torchvision state dict
(:func:`load_vgg_state`) or from the port's own seeded init
(:meth:`VGGFeatures.init_`): torch's default conv init drawn from a
``torch.Generator``, the distribution flax's init of the JAX twin draws
from, with other numbers. The port holds no pretrained VGG.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from endosr_torch.utils.device import device_constant

__all__ = ["VGGFeatures", "VGGFeatureExtractor", "VGG_CFGS", "IMAGENET_MEAN",
           "IMAGENET_STD", "load_vgg_state"]

VGG_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
              512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _imagenet():
    """[2, 1, 3, 1, 1]: the ImageNet mean and std, NCHW-broadcastable."""
    return np.array([IMAGENET_MEAN, IMAGENET_STD],
                    np.float32).reshape(2, 1, 3, 1, 1)


def _layers(cfg, max_layer):
    """[(torch index, "conv" | "relu" | "pool", conv or None)] of ``cfg``'s
    trunk up to ``max_layer`` (the JAX twin's walk: it stops once the index
    passes ``max_layer``, a conv's ReLU included)."""
    out, idx, cin = [], 0, 3
    for v in VGG_CFGS[cfg]:
        if max_layer is not None and idx > max_layer:
            break
        if v == "M":
            out.append((idx, "pool", None))
            idx += 1
            continue
        out.append((idx, "conv", nn.Conv2d(cin, v, 3, 1, 1)))
        cin, idx = v, idx + 1
        if max_layer is not None and idx > max_layer:
            break
        out.append((idx, "relu", None))
        idx += 1
    return out


class VGGFeatures(nn.Module):
    """VGG ``features`` with torch-index naming and taps.

    ``taps``: the ``features`` indices after which to emit the activation
    (with ``[4, 9, 18, 27]``: pool1–pool4); empty returns the last
    activation only. The trunk stops past ``max_layer``. Input: NCHW RGB
    in [0, 1] (ImageNet-normalized first with ``use_input_norm``).
    Without a weights file, :meth:`init_` draws the port's own weights,
    which are not the JAX package's flax init: the two packages then agree
    only on weights carried across (``port_params.from_flax_vgg``)."""

    def __init__(self, cfg: str = "vgg19", taps=(), max_layer=None,
                 use_input_norm: bool = False):
        super().__init__()
        self.taps = tuple(taps)
        self.use_input_norm = use_input_norm
        layers = _layers(cfg, max_layer)
        self._walk = [(i, kind) for i, kind, _ in layers]
        self.features = nn.ModuleDict(
            {str(i): m for i, kind, m in layers if kind == "conv"})

    def init_(self, gen: torch.Generator):
        """torch Conv2d's default init, U(−1/√fan_in, 1/√fan_in) for weight
        and bias, drawn on the CPU from ``gen``."""
        with torch.no_grad():
            for m in self.features.values():
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for t in (m.weight, m.bias):
                    t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound)
                            - bound)
        return self

    def forward(self, x):
        if self.use_input_norm:
            mean, std = device_constant(_imagenet, (), x.dtype, x.device)
            x = (x - mean) / std
        outputs = []
        for idx, kind in self._walk:
            if kind == "conv":
                x = self.features[str(idx)](x)
            elif kind == "relu":
                x = F.relu(x)
            else:
                x = F.max_pool2d(x, 2, 2)
            if idx in self.taps:
                outputs.append(x)
        return outputs if self.taps else x


class VGGFeatureExtractor(nn.Module):
    """VGG19 up to ``feature_layer`` with the ImageNet normalization."""

    def __init__(self, feature_layer: int = 34, use_input_norm: bool = True):
        super().__init__()
        self.vgg = VGGFeatures("vgg19", max_layer=feature_layer,
                               use_input_norm=use_input_norm)

    def forward(self, x):
        return self.vgg(x)


def load_vgg_state(model: VGGFeatures, path: str):
    """Load a torchvision VGG state dict (``features.N.weight`` / ``bias``;
    its classifier and the convs past the model's last layer are left
    out) into ``model``. A missing file raises ``FileNotFoundError``, as the
    JAX package's does."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"VGG weights not found at {path} (torchvision vgg checkpoints "
            "are external downloads)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict({k: sd[k] for k in model.state_dict()})
    return model
