"""SRGAN's discriminator, Discriminator_VGG_128 (counterpart of
``endosr/nn/discriminator.py``).

Five pairs of a 3×3 conv and a 4×4 stride-2 conv (BatchNorm after every
conv but the first, leaky ReLU 0.2), then two dense layers. NHWC in, fp32
logits [B, 1] out. Module names are the reference checkpoint's
(``conv0_0``, ``conv0_1``, ``bn0_1``, …, ``linear1``, ``linear2``), so a
reference ``state_dict`` loads as it is. BatchNorm is
:class:`~endosr_torch.nn.fcn.FlaxBatchNorm` (flax's statistics, momentum
0.9); the features are flattened in (C, H, W) order, as torch flattens
NCHW, so that a reference ``linear1`` lines up. ``linear1``'s input size
follows the HR size the network is built for (the JAX model infers it
from the configured ``LR_size × scale``; the reference's 128 gives
512·4·4).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from endosr_torch.nn.fcn import FlaxBatchNorm
from endosr_torch.nn.layers import Conv, Dense, init_leaves_, leaky_relu

__all__ = ["DiscriminatorVGG128", "strided_side", "flatten_chw"]

F32 = torch.float32


def strided_side(n: int, convs: int) -> int:
    """A side of ``n`` after ``convs`` 4×4 stride-2 pad-1 convs."""
    for _ in range(convs):
        n = (n + 2 - 4) // 2 + 1
    return n


def flatten_chw(x):
    """NHWC → [B, C·H·W] in (C, H, W) order."""
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


class DiscriminatorVGG128(nn.Module):
    def __init__(self, in_nc=3, nf=64, hr_size=128):
        super().__init__()
        self.conv0_0 = Conv(in_nc, nf, 3, 1, 1)
        self.conv0_1 = Conv(nf, nf, 4, 2, 1, bias=False)
        self.bn0_1 = FlaxBatchNorm(nf)
        cin = nf
        for i, mult in enumerate((2, 4, 8, 8), start=1):
            setattr(self, f"conv{i}_0", Conv(cin, nf * mult, 3, 1, 1,
                                             bias=False))
            setattr(self, f"bn{i}_0", FlaxBatchNorm(nf * mult))
            setattr(self, f"conv{i}_1", Conv(nf * mult, nf * mult, 4, 2, 1,
                                             bias=False))
            setattr(self, f"bn{i}_1", FlaxBatchNorm(nf * mult))
            cin = nf * mult
        side = strided_side(hr_size, 5)
        self.linear1 = Dense(nf * 8 * side * side, 100)
        self.linear2 = Dense(100, 1)

    def init_(self, gen):
        return init_leaves_(self, gen)

    def forward(self, x):
        fea = leaky_relu(self.conv0_0(x, F32), 0.2)
        fea = leaky_relu(self.bn0_1(self.conv0_1(fea, F32)), 0.2)
        for i in range(1, 5):
            for j in (0, 1):
                conv = getattr(self, f"conv{i}_{j}")
                fea = leaky_relu(getattr(self, f"bn{i}_{j}")(conv(fea, F32)),
                                 0.2)
        fea = leaky_relu(self.linear1(flatten_chw(fea)), 0.2)
        return self.linear2(fea).float()
