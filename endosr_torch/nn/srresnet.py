"""MSRResNet (counterpart of ``endosr/nn/srresnet.py``): BasicSR's
modified SRResNet — a trunk of no-BN residual blocks, PixelShuffle
upsampling and a bilinear-upsampled global skip from the input.

NHWC in and out, fp32. Parameter names are the JAX package's porter keys
(``recon_trunk.0.conv1.weight``, ``upconv1.weight``, ...). The seeded init
(``init_``) draws torch Conv2d's default bounds for every conv, as the JAX
module's init does (its 0.1-scaled kaiming helper is defined there and
called by no module).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from endosr_torch.nn.layers import Conv, init_leaves_, leaky_relu, pixel_shuffle
from endosr_torch.ops.resize import interpolate_bilinear

__all__ = ["MSRResNet", "ResidualBlockNoBN"]

F32 = torch.float32


class ResidualBlockNoBN(nn.Module):
    """conv → ReLU → conv, + the input."""

    def __init__(self, nf=64):
        super().__init__()
        self.conv1 = Conv(nf, nf, 3, 1, 1)
        self.conv2 = Conv(nf, nf, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(x, F32)), F32)


class MSRResNet(nn.Module):
    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=16, upscale=4):
        super().__init__()
        self.upscale = int(upscale)
        self.conv_first = Conv(in_nc, nf, 3, 1, 1)
        self.recon_trunk = nn.ModuleList(ResidualBlockNoBN(nf)
                                         for _ in range(nb))
        if self.upscale == 4:
            self.upconv1 = Conv(nf, nf * 4, 3, 1, 1)
            self.upconv2 = Conv(nf, nf * 4, 3, 1, 1)
        elif self.upscale in (2, 3):
            self.upconv1 = Conv(nf, nf * self.upscale ** 2, 3, 1, 1)
        self.HRconv = Conv(nf, nf, 3, 1, 1)
        self.conv_last = Conv(nf, out_nc, 3, 1, 1)

    def init_(self, gen):
        return init_leaves_(self, gen)

    def forward(self, x):
        fea = leaky_relu(self.conv_first(x, F32), 0.1)
        out = fea
        for blk in self.recon_trunk:
            out = blk(out)
        if self.upscale == 4:
            out = leaky_relu(pixel_shuffle(self.upconv1(out, F32), 2), 0.1)
            out = leaky_relu(pixel_shuffle(self.upconv2(out, F32), 2), 0.1)
        elif self.upscale in (2, 3):
            out = leaky_relu(pixel_shuffle(self.upconv1(out, F32),
                                           self.upscale), 0.1)
        out = leaky_relu(self.HRconv(out, F32), 0.1)
        out = self.conv_last(out, F32)
        base = interpolate_bilinear(
            x, (x.shape[1] * self.upscale, x.shape[2] * self.upscale),
            align_corners=False)
        return out + base
