"""monodepth2's networks (counterpart of ``endosr/nn/monodepth.py``).

* :class:`ResnetEncoder` — a torchvision-layout ResNet-18/34/50 under
  ``encoder.`` with the (x − 0.45)/0.225 input normalization and five
  feature taps (``endosr/nn/monodepth.py:97-139``); the input is
  ``num_input_images`` RGB images stacked on the channel axis.
* :class:`DepthDecoder` — the skip-connected upconv decoder: reflect-padded
  3×3 convs, ELU, nearest ×2 upsampling and a sigmoid disparity head at
  scales 0–3, in fp32 (``endosr/nn/monodepth.py:142-171``).
* :class:`PoseDecoder` — the pose head over a ResNet encoder's last
  feature map: a 1×1 squeeze, two 3×3 convs, a 1×1 conv to 6 values a
  frame, the spatial mean scaled by 0.01 (``endosr/nn/monodepth.py:
  177-198``). The pose encoder is a :class:`ResnetEncoder` with
  ``num_input_images=2``.
* :class:`PoseCNN` — seven strided convs and a 1×1 ``pose_conv`` on the
  stacked frames (``endosr/nn/monodepth.py:201-215``).

The submodules carry monodepth2's own names, so its ``encoder.pth`` (less
``height``, ``width``, ``use_stereo`` and torchvision's classifier
``encoder.fc``, which the forward does not use) and ``depth.pth`` load
through ``load_state_dict`` as they are
(``utils/port_params.py::load_monodepth``):
``encoder.layerL.B.conv1.weight``, ``encoder.layerL.B.downsample.1.
running_var``, ``decoder.N.conv.conv.weight`` for the upconvs and
``decoder.N.conv.weight`` for the heads, N counting the upconvs from scale
4 down, then the heads from scale 0. So do ``pose.pth``'s: ``net.0..3``
for the pose decoder (squeeze, pose 0–2), ``net.0..6`` and ``pose_conv``
for the PoseCNN.

NCHW inside, plain ``torch.nn`` (cuDNN convolutions on the card: the JAX
package computes these networks outside any Pallas kernel). BatchNorm runs
from its running statistics (ε 1e-5) in ``eval()``; in ``train()`` it
normalises by the batch's statistics, and the depth trainer keeps its
running statistics as they are, as JAX's does (``ROADMAP.md`` C8:
:func:`freeze_running_stats`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from endosr_torch.ops.resize import interpolate_nearest

__all__ = ["ResnetEncoder", "DepthDecoder", "PoseDecoder", "PoseCNN",
           "BasicBlock", "Bottleneck", "NUM_CH_DEC", "freeze_running_stats"]

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


class PoseDecoder(nn.Module):
    """Pose encoders' features → (axis-angle, translation), each [B,
    ``num_frames_to_predict_for``, 1, 3] fp32. ``input_features`` is a
    list of ``num_input_features`` feature lists; each list's last map is
    used."""

    def __init__(self, num_ch_enc=(64, 64, 128, 256, 512),
                 num_input_features: int = 1,
                 num_frames_to_predict_for: int | None = None,
                 stride: int = 1):
        super().__init__()
        self.num_frames = (num_frames_to_predict_for
                           or num_input_features - 1)
        self.net = nn.ModuleList([
            nn.Conv2d(num_ch_enc[-1], 256, 1),
            nn.Conv2d(num_input_features * 256, 256, 3, stride, 1),
            nn.Conv2d(256, 256, 3, stride, 1),
            nn.Conv2d(256, 6 * self.num_frames, 1)])

    def forward(self, input_features):
        squeeze, pose0, pose1, pose2 = self.net
        out = torch.cat([F.relu(squeeze(f[-1])) for f in input_features], 1)
        out = F.relu(pose1(F.relu(pose0(out))))
        out = pose2(out).mean(dim=(2, 3))
        out = 0.01 * out.reshape(-1, self.num_frames, 1, 6).float()
        return out[..., :3], out[..., 3:]


_POSECNN_SPECS = ((16, 7, 2, 3), (32, 5, 2, 2), (64, 3, 2, 1), (128, 3, 2, 1),
                  (256, 3, 2, 1), (256, 3, 2, 1), (256, 3, 2, 1))


class PoseCNN(nn.Module):
    """``num_input_frames`` RGB frames stacked on the channel axis (NCHW)
    → (axis-angle, translation), each [B, frames − 1, 1, 3] fp32."""

    def __init__(self, num_input_frames: int = 2):
        super().__init__()
        self.num_frames = num_input_frames - 1
        convs, cin = [], 3 * num_input_frames
        for cout, k, s, p in _POSECNN_SPECS:
            convs.append(nn.Conv2d(cin, cout, k, s, p))
            cin = cout
        self.net = nn.ModuleList(convs)
        self.pose_conv = nn.Conv2d(cin, 6 * self.num_frames, 1)

    def forward(self, x):
        for conv in self.net:
            x = F.relu(conv(x))
        x = self.pose_conv(x).mean(dim=(2, 3))
        x = 0.01 * x.reshape(-1, self.num_frames, 1, 6).float()
        return x[..., :3], x[..., 3:]


def freeze_running_stats(module: nn.Module) -> nn.Module:
    """Set every BatchNorm's momentum under ``module`` to 0: in
    ``train()`` it still normalises by the batch's statistics, and its
    running mean and variance stay bit for bit as they are (JAX's depth
    trainer never writes back the statistics it computes, ``ROADMAP.md``
    C8). Returns ``module``."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = 0.0
    return module
