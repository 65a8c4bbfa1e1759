"""The SFTMD family, kernel-code conditioned SR networks of IKC
(counterpart of ``endosr/nn/sftmd.py``): the kernel-code estimators
``Predictor`` and ``Corrector``, the SFT layer and residual block,
``SFTMD`` and ``SFTMDDemo``. The kernel code [B, P] is stretched to a
spatial map and modulates the features through SFT layers.

NHWC in and out, fp32; parameter names are the JAX package's porter keys
(``ConvNet.0.weight``, ``code_dense.0.weight``, ``SFT_residual1.sft1.
mul_conv1.weight``, ``upscale_0.weight``, ...). As in the JAX modules the
SFT blocks' convs are 64 wide whatever ``nf`` says, so ``nf`` other than
64 does not build a working SFTMD (in either package).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from endosr_torch.nn.layers import (Conv, Dense, clip, init_leaves_,
                                    leaky_relu, pixel_shuffle)

__all__ = ["Predictor", "Corrector", "SFTLayer", "SFTResidualBlock",
           "SFTMD", "SFTMDDemo"]

F32 = torch.float32


def _stretch(code, x):
    """[B, P] → [B, H, W, P] at ``x``'s spatial size."""
    b, h, w, _ = x.shape
    return code[:, None, None, :].expand(b, h, w, code.shape[-1]).to(F32)


class Predictor(nn.Module):
    """LR image → kernel code [B, code_len]: six 5×5 convs (the fourth of
    stride 2), leaky ReLU after each, global average pool."""

    STRIDES = (1, 1, 1, 2, 1, 1)

    def __init__(self, in_nc=3, nf=64, code_len=10, use_bias=True):
        super().__init__()
        chans = (in_nc,) + (nf,) * 5 + (code_len,)
        self.ConvNet = nn.ModuleDict({
            str(2 * i): Conv(chans[i], chans[i + 1], 5, s, 2,
                             bias=(i == 0) or use_bias)
            for i, s in enumerate(self.STRIDES)})

    def init_(self, gen):
        return init_leaves_(self, gen)

    def forward(self, x):
        for conv in self.ConvNet.values():
            x = leaky_relu(conv(x, F32), 0.2)
        return x.mean(dim=(1, 2))


class Corrector(nn.Module):
    """SR image + estimated code → the corrected code (with ``res``, the
    correction alone)."""

    STRIDES = (1, 2, 1, 2, 1, 1, 1)

    def __init__(self, in_nc=3, nf=64, code_len=10, use_bias=True):
        super().__init__()
        self.ConvNet = nn.ModuleDict({
            str(2 * i): Conv(in_nc if i == 0 else nf, nf, 5, s, 2,
                             bias=use_bias)
            for i, s in enumerate(self.STRIDES)})
        self.code_dense = nn.ModuleDict({
            "0": Dense(code_len, nf, use_bias), "2": Dense(nf, nf, use_bias)})
        self.global_dense = nn.ModuleDict({
            "0": Conv(2 * nf, 2 * nf, 1, 1, 0, bias=use_bias),
            "2": Conv(2 * nf, nf, 1, 1, 0, bias=use_bias),
            "4": Conv(nf, code_len, 1, 1, 0, bias=use_bias)})

    def init_(self, gen):
        return init_leaves_(self, gen)

    def forward(self, x, code, res: bool = False):
        h = x
        for conv in self.ConvNet.values():
            h = leaky_relu(conv(h, F32), 0.2)
        c = leaky_relu(self.code_dense["0"](code), 0.2)
        c = leaky_relu(self.code_dense["2"](c), 0.2)
        m = torch.cat([h, _stretch(c, h)], -1)
        m = leaky_relu(self.global_dense["0"](m, F32), 0.2)
        m = leaky_relu(self.global_dense["2"](m, F32), 0.2)
        delta = self.global_dense["4"](m, F32).mean(dim=(1, 2))
        return delta if res else delta + code


class SFTLayer(nn.Module):
    """Spatial feature transform: features·σ(mul) + add, mul and add from
    two-conv branches on the features concatenated with the code map."""

    def __init__(self, nf=64, para=10, in_nf=None):
        super().__init__()
        cin = (nf if in_nf is None else in_nf) + para
        self.mul_conv1 = Conv(cin, 32, 3, 1, 1)
        self.mul_conv2 = Conv(32, nf, 3, 1, 1)
        self.add_conv1 = Conv(cin, 32, 3, 1, 1)
        self.add_conv2 = Conv(32, nf, 3, 1, 1)

    def forward(self, features, para_maps):
        cat = torch.cat([features, para_maps], -1)
        mul = self.mul_conv2(leaky_relu(self.mul_conv1(cat, F32), 0.2), F32)
        add = self.add_conv2(leaky_relu(self.add_conv1(cat, F32), 0.2), F32)
        return features * torch.sigmoid(mul) + add


class SFTResidualBlock(nn.Module):
    def __init__(self, nf=64, para=10):
        super().__init__()
        self.sft1 = SFTLayer(nf, para, in_nf=64)
        self.conv1 = Conv(nf, 64, 3, 1, 1)
        self.sft2 = SFTLayer(nf, para, in_nf=64)
        self.conv2 = Conv(nf, 64, 3, 1, 1)

    def forward(self, features, para_maps):
        fea1 = self.conv1(torch.relu(self.sft1(features, para_maps)), F32)
        fea2 = torch.relu(self.sft2(fea1, para_maps))
        return features + self.conv2(fea2, F32)


class SFTMD(nn.Module):
    """The kernel-code conditioned SFTMD (``which_model_G: SFTMD_kernel``):
    (LR image, kernel code) → SR, clamped."""

    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=16, scale=4,
                 input_para=10, clamp_min=0.0, clamp_max=1.0):
        super().__init__()
        self.scale, self.clamp = int(scale), (clamp_min, clamp_max)
        self.conv1 = Conv(in_nc, 64, 3, 1, 1)
        self.conv2 = Conv(64, 64, 3, 1, 1)
        self.conv3 = Conv(64, 64, 3, 1, 1)
        for i in range(nb):
            setattr(self, f"SFT_residual{i + 1}",
                    SFTResidualBlock(nf, input_para))
        self.nb = nb
        self.sft = SFTLayer(64, input_para)
        self.conv_mid = Conv(64, 64, 3, 1, 1)
        if self.scale == 4:
            self.upscale_0 = Conv(64, 256, 3, 1, 1)
            self.upscale_3 = Conv(64, 256, 3, 1, 1)
        else:
            self.upscale_0 = Conv(64, 64 * self.scale ** 2, 3, 1, 1)
        self.conv_output = Conv(64, out_nc, 9, 1, 4)

    def init_(self, gen):
        return init_leaves_(self, gen)

    def forward(self, x, ker_code):
        code = _stretch(ker_code, x)
        fea = leaky_relu(self.conv1(x, F32), 0.2)
        fea = leaky_relu(self.conv2(fea, F32), 0.2)
        fea_bef = self.conv3(fea, F32)
        fea_in = fea_bef
        for i in range(self.nb):
            fea_in = getattr(self, f"SFT_residual{i + 1}")(fea_in, code)
        fea = self.conv_mid(self.sft(fea_in + fea_bef, code), F32)
        if self.scale == 4:
            fea = leaky_relu(pixel_shuffle(self.upscale_0(fea, F32), 2))
            fea = leaky_relu(pixel_shuffle(self.upscale_3(fea, F32), 2))
        else:
            fea = leaky_relu(pixel_shuffle(self.upscale_0(fea, F32),
                                           self.scale))
        return clip(self.conv_output(fea, F32), *self.clamp)


class SFTMDDemo(nn.Module):
    """SFTMD_DEMO: the code map is also concatenated to the input image;
    the tail's convs have no bias; clamped only with ``clip``."""

    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=16, scale=4,
                 input_para=10, clamp_min=0.0, clamp_max=1.0):
        super().__init__()
        self.clamp, self.nb = (clamp_min, clamp_max), nb
        self.conv1 = Conv(in_nc + input_para, 64, 3, 1, 1)
        self.conv2 = Conv(64, 64, 3, 1, 1)
        self.conv3 = Conv(64, 64, 3, 1, 1)
        for i in range(nb):
            setattr(self, f"SFT_residual{i + 1}",
                    SFTResidualBlock(64, input_para))
        self.sft_mid = SFTLayer(nf, input_para, in_nf=64)
        self.conv_mid = Conv(nf, 64, 3, 1, 1, bias=False)
        self.ups = {4: (2, 2), 3: (3,), 2: (2,)}.get(int(scale), (2, 2))
        for j, r in enumerate(self.ups):
            setattr(self, f"upscale_{3 * j}",
                    Conv(64, 64 * r * r, 3, 1, 1, bias=False))
        self.conv_output = Conv(64, out_nc, 9, 1, 4, bias=False)

    def init_(self, gen):
        return init_leaves_(self, gen)

    def forward(self, x, code, clip_out: bool = False):
        code_map = _stretch(code, x)
        inp = torch.cat([x.float(), code_map], -1)
        fea = leaky_relu(self.conv1(inp, F32), 0.2)
        fea = leaky_relu(self.conv2(fea, F32), 0.2)
        before_res = self.conv3(fea, F32)
        res = before_res
        for i in range(self.nb):
            res = getattr(self, f"SFT_residual{i + 1}")(res, code_map)
        mid = self.conv_mid(torch.relu(self.sft_mid(res, code_map)), F32)
        fea = before_res + mid
        for j, r in enumerate(self.ups):
            fea = leaky_relu(pixel_shuffle(
                getattr(self, f"upscale_{3 * j}")(fea, F32), r))
        out = self.conv_output(fea, F32)
        return clip(out, *self.clamp) if clip_out else out
