"""RRDBNet, ESRGAN's generator (counterpart of ``endosr/nn/rrdb.py``):
residual-in-residual dense blocks with ×0.2 residual scaling and two
nearest-neighbour ×2 upsamplings (×4 whatever the options' scale, as the
JAX module).

NHWC in and out, fp32; parameter names ``RRDB_trunk.N.RDB1.conv1.weight``,
``trunk_conv.weight``, ... (the JAX package's porter keys).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from endosr_torch.nn.layers import Conv, init_leaves_, leaky_relu
from endosr_torch.ops.resize import interpolate_nearest

__all__ = ["RRDBNet", "RRDB", "ResidualDenseBlock5C"]

F32 = torch.float32


class ResidualDenseBlock5C(nn.Module):
    def __init__(self, nf=64, gc=32):
        super().__init__()
        self.conv1 = Conv(nf, gc, 3, 1, 1)
        self.conv2 = Conv(nf + gc, gc, 3, 1, 1)
        self.conv3 = Conv(nf + 2 * gc, gc, 3, 1, 1)
        self.conv4 = Conv(nf + 3 * gc, gc, 3, 1, 1)
        self.conv5 = Conv(nf + 4 * gc, nf, 3, 1, 1)

    def forward(self, x):
        feats = [x]
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            feats.append(leaky_relu(conv(torch.cat(feats, -1), F32), 0.2))
        return self.conv5(torch.cat(feats, -1), F32) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf=64, gc=32):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc)
        self.RDB2 = ResidualDenseBlock5C(nf, gc)
        self.RDB3 = ResidualDenseBlock5C(nf, gc)

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=23, gc=32):
        super().__init__()
        self.conv_first = Conv(in_nc, nf, 3, 1, 1)
        self.RRDB_trunk = nn.ModuleList(RRDB(nf, gc) for _ in range(nb))
        self.trunk_conv = Conv(nf, nf, 3, 1, 1)
        self.upconv1 = Conv(nf, nf, 3, 1, 1)
        self.upconv2 = Conv(nf, nf, 3, 1, 1)
        self.HRconv = Conv(nf, nf, 3, 1, 1)
        self.conv_last = Conv(nf, out_nc, 3, 1, 1)

    def init_(self, gen):
        return init_leaves_(self, gen)

    def forward(self, x):
        fea = self.conv_first(x, F32)
        trunk = fea
        for blk in self.RRDB_trunk:
            trunk = blk(trunk)
        fea = fea + self.trunk_conv(trunk, F32)
        for conv in (self.upconv1, self.upconv2):
            fea = interpolate_nearest(fea, (fea.shape[1] * 2, fea.shape[2] * 2))
            fea = leaky_relu(conv(fea, F32), 0.2)
        out = leaky_relu(self.HRconv(fea, F32), 0.2)
        return self.conv_last(out, F32)
