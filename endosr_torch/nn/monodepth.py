"""monodepth2's inference networks (counterpart of ``endosr/nn/monodepth.py``).

* :class:`ResnetEncoder` — a torchvision-layout ResNet-18/34/50 under
  ``encoder.`` with the (x − 0.45)/0.225 input normalization and five
  feature taps (``endosr/nn/monodepth.py:97-139``); the input is
  ``num_input_images`` RGB images stacked on the channel axis.
* :class:`DepthDecoder` — the skip-connected upconv decoder: reflect-padded
  3×3 convs, ELU, nearest ×2 upsampling and a sigmoid disparity head at
  scales 0–3, in fp32 (``endosr/nn/monodepth.py:142-171``).

The submodules carry monodepth2's own names, so its ``encoder.pth`` (less
``height``, ``width``, ``use_stereo`` and torchvision's classifier
``encoder.fc``, which the forward does not use) and ``depth.pth`` load
through ``load_state_dict`` as they are
(``utils/port_params.py::load_monodepth``):
``encoder.layerL.B.conv1.weight``, ``encoder.layerL.B.downsample.1.
running_var``, ``decoder.N.conv.conv.weight`` for the upconvs and
``decoder.N.conv.weight`` for the heads, N counting the upconvs from scale
4 down, then the heads from scale 0.

NCHW inside, plain ``torch.nn`` (cuDNN convolutions on the card: the JAX
package computes these networks outside any Pallas kernel). BatchNorm runs
from its running statistics (ε 1e-5) whenever the module is in ``eval()``,
the mode every user of the port's networks keeps them in; the pose
networks wait for the depth trainer.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from endosr_torch.ops.resize import interpolate_nearest

__all__ = ["ResnetEncoder", "DepthDecoder", "BasicBlock", "Bottleneck",
           "NUM_CH_DEC"]

NUM_CH_DEC = (16, 32, 64, 128, 256)


def _conv(cin, cout, k, stride=1, pad=0):
    return nn.Conv2d(cin, cout, k, stride, pad, bias=False)


def _downsample(cin, cout, stride):
    return nn.Sequential(_conv(cin, cout, 1, stride), nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (_downsample(cin, planes, stride) if downsample
                           else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (_downsample(cin, planes * 4, stride) if downsample
                           else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idt)


_RESNET_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
}


class _ResNet(nn.Module):
    """torchvision's ResNet trunk (no classifier), by its module names."""

    def __init__(self, num_layers, num_input_images):
        super().__init__()
        block, layers = _RESNET_SPECS[num_layers]
        self.conv1 = _conv(3 * num_input_images, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers),
                                              start=1):
            seq = []
            for bi in range(blocks):
                s = 1 if li == 1 or bi else 2
                seq.append(block(cin, planes, s, downsample=bi == 0 and (
                    s != 1 or cin != planes * block.expansion)))
                cin = planes * block.expansion
            setattr(self, f"layer{li}", nn.Sequential(*seq))


class ResnetEncoder(nn.Module):
    """monodepth2's ResNet feature encoder: NCHW images in [0, 1] → five
    feature maps (after conv1+bn1+ReLU, then after each of layer1–4)."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        if num_layers not in _RESNET_SPECS:
            raise ValueError(f"{num_layers} is not a valid number of resnet "
                             "layers (18, 34 or 50)")
        self.num_layers = num_layers
        self.encoder = _ResNet(num_layers, num_input_images)

    @property
    def num_ch_enc(self):
        return ((64, 256, 512, 1024, 2048) if self.num_layers > 34
                else (64, 64, 128, 256, 512))

    def forward(self, x):
        e = self.encoder
        h = F.relu(e.bn1(e.conv1((x - 0.45) / 0.225)))
        features = [h]
        h = e.maxpool(h)
        for li in range(1, 5):
            h = getattr(e, f"layer{li}")(h)
            features.append(h)
        return features


class _Conv3x3(nn.Module):
    """Reflection pad 1 + 3×3 conv (monodepth2's ``Conv3x3``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class _ConvBlock(nn.Module):
    """``_Conv3x3`` + ELU (monodepth2's ``ConvBlock``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _Conv3x3(cin, cout)

    def forward(self, x):
        return F.elu(self.conv(x))


def _upsample2(x):
    """Nearest ×2 of an NCHW map, through the NHWC ``interpolate_nearest``
    on its channels-last view."""
    h, w = x.shape[2], x.shape[3]
    return interpolate_nearest(x.permute(0, 2, 3, 1),
                               (2 * h, 2 * w)).permute(0, 3, 1, 2)


class DepthDecoder(nn.Module):
    """Encoder features → {("disp", s): sigmoid disparity [B, C, H/2^s,
    W/2^s] fp32} for s in ``scales``."""

    def __init__(self, num_ch_enc=(64, 64, 128, 256, 512), scales=(0, 1, 2, 3),
                 num_output_channels: int = 1, use_skips: bool = True):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        convs = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            convs.append(_ConvBlock(cin, NUM_CH_DEC[i]))
            cin = NUM_CH_DEC[i] + (num_ch_enc[i - 1] if use_skips and i > 0
                                   else 0)
            convs.append(_ConvBlock(cin, NUM_CH_DEC[i]))
        convs += [_Conv3x3(NUM_CH_DEC[s], num_output_channels)
                  for s in self.scales]
        self.decoder = nn.ModuleList(convs)

    def forward(self, input_features):
        outputs = {}
        x = input_features[-1]
        for n, i in enumerate(range(4, -1, -1)):
            x = _upsample2(self.decoder[2 * n](x))
            if self.use_skips and i > 0:
                x = torch.cat([x, input_features[i - 1]], dim=1)
            x = self.decoder[2 * n + 1](x)
            if i in self.scales:
                head = self.decoder[10 + self.scales.index(i)]
                outputs[("disp", i)] = torch.sigmoid(head(x).float())
        return outputs
