"""SFT-GAN's networks (counterpart of ``endosr/nn/sft_arch.py``): the
segmentation-conditioned generator :class:`SFTNet`, its torch-version
variant :class:`SFTNetTorch`, and the auxiliary-classifier discriminator
:class:`ACDVGGBN96`.

A condition network (a 4×4 stride-4 conv, then 1×1 convs, leaky ReLU 0.1)
maps the 8-channel segmentation probabilities at HR to 32 channels at LR;
every SFT layer turns them into a per-pixel scale and shift of the 64
feature channels. :class:`SFTNet` (slope 0.1, ``fea·(scale + 1) +
shift``) upsamples ×4 by two pixel shuffles; :class:`SFTNetTorch` (slope
0.01, ``fea·scale + shift``, ReLU before each residual conv) by two
nearest upsamplings. NHWC in and out, fp32.

Module names are the reference checkpoint's (``conv0``,
``sft_branch.3.sft0.SFT_scale_conv0``, ``sft_branch.17``, ``CondNet.0``,
``HR_branch.3``; ``feature.3``, ``gan.0``, ``cls.2``), so a reference
``state_dict`` loads as it is; ``utils/port_params.py::from_flax_gan``
carries the JAX modules' variables across.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from endosr_torch.nn.discriminator import flatten_chw, strided_side
from endosr_torch.nn.fcn import FlaxBatchNorm
from endosr_torch.nn.layers import (Conv, Dense, init_leaves_, leaky_relu,
                                    pixel_shuffle)
from endosr_torch.ops.resize import interpolate_nearest

__all__ = ["SFTNet", "SFTNetTorch", "ACDVGGBN96", "SFTLayer", "ResBlockSFT",
           "CondNet"]

F32 = torch.float32


class SFTLayer(nn.Module):
    """Scale and shift of 64 feature channels from the 32-channel
    condition (two 1×1 convs each)."""

    def __init__(self, slope=0.1, plus_one=True):
        super().__init__()
        self.slope, self.plus_one = slope, plus_one
        self.SFT_scale_conv0 = Conv(32, 32, 1, 1, 0)
        self.SFT_scale_conv1 = Conv(32, 64, 1, 1, 0)
        self.SFT_shift_conv0 = Conv(32, 32, 1, 1, 0)
        self.SFT_shift_conv1 = Conv(32, 64, 1, 1, 0)

    def forward(self, fea, cond):
        scale = self.SFT_scale_conv1(
            leaky_relu(self.SFT_scale_conv0(cond, F32), self.slope), F32)
        shift = self.SFT_shift_conv1(
            leaky_relu(self.SFT_shift_conv0(cond, F32), self.slope), F32)
        if self.plus_one:
            return fea * (scale + 1) + shift
        return fea * scale + shift


class ResBlockSFT(nn.Module):
    def __init__(self, torch_variant=False):
        super().__init__()
        self.torch_variant = torch_variant
        slope, plus_one = (0.01, False) if torch_variant else (0.1, True)
        self.sft0 = SFTLayer(slope, plus_one)
        self.conv0 = Conv(64, 64, 3, 1, 1)
        self.sft1 = SFTLayer(slope, plus_one)
        self.conv1 = Conv(64, 64, 3, 1, 1)

    def forward(self, fea, cond):
        h = self.sft0(fea, cond)
        if self.torch_variant:
            h = self.conv0(torch.relu(h), F32)
            h = self.conv1(torch.relu(self.sft1(h, cond)), F32)
        else:
            h = torch.relu(self.conv0(h, F32))
            h = self.conv1(self.sft1(h, cond), F32)
        return fea + h


class CondNet(nn.ModuleDict):
    """8-channel segmentation at HR → the 32-channel condition at LR."""

    def __init__(self):
        super().__init__({"0": Conv(8, 128, 4, 4, 0),
                          **{str(i): Conv(128, 128, 1, 1, 0) for i in (2, 4, 6)},
                          "8": Conv(128, 32, 1, 1, 0)})

    def forward(self, seg):
        h = seg
        for i in (0, 2, 4, 6):
            h = leaky_relu(self[str(i)](h, F32), 0.1)
        return self["8"](h, F32)


class _SFTTrunk(nn.Module):
    """conv0, the 16 SFT residual blocks, an SFT layer and a conv (the
    ``sft_branch``), the global skip, and ``HR_branch``'s convs."""

    torch_variant = False
    hr_convs: dict = {}

    def __init__(self):
        super().__init__()
        tv = self.torch_variant
        self.CondNet = CondNet()
        self.conv0 = Conv(3, 64, 3, 1, 1)
        slope, plus_one = (0.01, False) if tv else (0.1, True)
        self.sft_branch = nn.ModuleDict(
            {**{str(i): ResBlockSFT(tv) for i in range(16)},
             "16": SFTLayer(slope, plus_one), "17": Conv(64, 64, 3, 1, 1)})
        self.HR_branch = nn.ModuleDict(
            {k: Conv(cin, cout, 3, 1, 1)
             for k, (cin, cout) in self.hr_convs.items()})

    def init_(self, gen):
        return init_leaves_(self, gen)

    def trunk(self, img, seg):
        cond = self.CondNet(seg)
        fea = self.conv0(img, F32)
        h = fea
        for i in range(16):
            h = self.sft_branch[str(i)](h, cond)
        h = self.sft_branch["16"](h, cond)
        return fea + self.sft_branch["17"](h, F32)

    def _hr(self, key, x):
        return self.HR_branch[key](x, F32)


class SFTNet(_SFTTrunk):
    """SFT-GAN's generator (×4): ``img`` [B,H,W,3], ``seg`` [B,4H,4W,8]."""

    hr_convs = {"0": (64, 256), "3": (64, 256), "6": (64, 64), "8": (64, 3)}

    def forward(self, img, seg):
        fea = self.trunk(img, seg)
        h = torch.relu(pixel_shuffle(self._hr("0", fea), 2))
        h = torch.relu(pixel_shuffle(self._hr("3", h), 2))
        h = torch.relu(self._hr("6", h))
        return self._hr("8", h)


class SFTNetTorch(_SFTTrunk):
    """The torch-version generator: nearest ×2 upsampling twice."""

    torch_variant = True
    hr_convs = {"1": (64, 64), "4": (64, 64), "6": (64, 64), "8": (64, 3)}

    def forward(self, img, seg):
        fea = self.trunk(img, seg)
        h = interpolate_nearest(fea, (fea.shape[1] * 2, fea.shape[2] * 2))
        h = torch.relu(self._hr("1", h))
        h = interpolate_nearest(h, (h.shape[1] * 2, h.shape[2] * 2))
        h = torch.relu(self._hr("4", h))
        h = torch.relu(self._hr("6", h))
        return self._hr("8", h)


# ``feature`` index of each conv: (out channels, kernel, stride); a conv
# but the first is followed by the BatchNorm at the next index
_ACD_FEATURES = ((0, 64, 3, 1), (2, 64, 4, 2), (5, 128, 3, 1),
                 (8, 128, 4, 2), (11, 256, 3, 1), (14, 256, 4, 2),
                 (17, 512, 3, 1), (20, 512, 4, 2))


class ACDVGGBN96(nn.Module):
    """The auxiliary-classifier discriminator: NHWC HR images → (GAN logit
    [B, 1], class logits [B, num_classes]), fp32. Biased convs, BatchNorm
    after every conv but the first, leaky ReLU 0.1; ``hr_size`` sets the
    dense layers' input (the reference's 96: 512·6·6)."""

    def __init__(self, num_classes=8, hr_size=96):
        super().__init__()
        layers, cin = {}, 3
        for idx, cout, k, s in _ACD_FEATURES:
            layers[str(idx)] = Conv(cin, cout, k, s, 1)
            if idx:
                layers[str(idx + 1)] = FlaxBatchNorm(cout)
            cin = cout
        self.feature = nn.ModuleDict(layers)
        side = strided_side(hr_size, 4)
        n = 512 * side * side
        self.gan = nn.ModuleDict({"0": Dense(n, 100), "2": Dense(100, 1)})
        self.cls = nn.ModuleDict({"0": Dense(n, 100),
                                  "2": Dense(100, num_classes)})

    def init_(self, gen):
        return init_leaves_(self, gen)

    def forward(self, x):
        h = x
        for idx, *_ in _ACD_FEATURES:
            h = self.feature[str(idx)](h, F32)
            if idx:
                h = self.feature[str(idx + 1)](h)
            h = leaky_relu(h, 0.1)
        h = flatten_chw(h)
        gan = self.gan["2"](leaky_relu(self.gan["0"](h), 0.1))
        cls = self.cls["2"](leaky_relu(self.cls["0"](h), 0.1))
        return gan.float(), cls.float()
