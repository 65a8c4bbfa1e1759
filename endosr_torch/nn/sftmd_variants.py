"""The depth-aware SFTMD variants between plain SFTMD and DepthNet
(counterpart of ``endosr/nn/sftmd_variants.py``):

* :class:`PositionAttention` / :class:`PositionAttentionEfficient` —
  DANet-style spatial attention between features and a depth embedding
  (the quadratic one is built by no network, as in JAX);
* :class:`SPADE` — depth-map-conditioned normalization, and
  :class:`DepthResidualBlockSPADE`, the depth block before SEAN;
* the networks :class:`SFTMDUpscaleAfterResBlk` (×8, classic trunk),
  :class:`SFTMDUpscaleAfterResBlkDepthCondition` (a 3-conv depth branch
  conditions the SPADE blocks ``which_resblk_depth`` picks),
  :class:`SFTMDUpscaleAfterResBlkDepth` (n trailing SPADE blocks, with
  ``pred_depth`` learned ×2 depth upsamplers whose outputs the network
  also returns) and :class:`SFTMDNoKernel` (``which_model_G: SFTMD``).

NHWC in and out, fp32. The classic blocks are DepthNet's
(``nn/depthnet.py::ClassicResidualBlock``); parameter names are the JAX
package's porter keys (``head.0.weight_v``, ``classic-residual3.block.0.
weight_v``, ``depth-residual13.norm1.mlp_shared.0.weight``,
``upscale1.3.weight_g``, ``depth_upscale1.res.block.2.bias``, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from endosr_torch.nn.depthnet import ClassicResidualBlock
from endosr_torch.nn.layers import (Conv, WNConv, clip, init_leaves_,
                                    instance_norm, leaky_relu, pixel_shuffle)
from endosr_torch.ops.resize import interpolate_nearest
from endosr_torch.parallel.spatial import refuse as spatial_refuse

__all__ = ["PositionAttention", "PositionAttentionEfficient", "SPADE",
           "DepthResidualBlockSPADE", "SFTMDUpscaleAfterResBlk",
           "SFTMDUpscaleAfterResBlkDepth",
           "SFTMDUpscaleAfterResBlkDepthCondition", "SFTMDNoKernel"]

F32 = torch.float32


class _AttentionConvs(nn.Module):
    def __init__(self, in_channels, depth_ch):
        super().__init__()
        c = in_channels
        self.conv_a = nn.ModuleDict({"0": Conv(depth_ch, c, 1, 1, 0)})
        self.conv_b = Conv(c, c // 8, 1, 1, 0)
        self.conv_c = Conv(c, c // 8, 1, 1, 0)
        self.conv_d = Conv(c, c, 1, 1, 0)

    def feats(self, features, depth):
        """(b, c, d) features, each [B, H·W, channels]."""
        bsz, h, w, _ = features.shape
        d = torch.relu(self.conv_a["0"](depth, F32))
        flat = [t.reshape(bsz, h * w, -1) for t in
                (self.conv_b(features, F32), self.conv_c(d, F32),
                 self.conv_d(d, F32))]
        return flat


class PositionAttention(_AttentionConvs):
    """Quadratic spatial attention feature ← depth: softmax over the depth
    pixels of the [H·W, H·W] similarity."""

    def forward(self, features, depth):
        spatial_refuse("PositionAttention")
        bsz, h, w, c = features.shape
        b_feat, c_feat, d_feat = self.feats(features, depth)
        attn = torch.softmax(torch.einsum("bnc,bmc->bnm", b_feat, c_feat), -1)
        out = torch.einsum("bmc,bnm->bnc", d_feat, attn)
        return out.reshape(bsz, h, w, c)


class PositionAttentionEfficient(_AttentionConvs):
    """The linear-complexity reordering: a [C, C/8] channel attention."""

    def forward(self, features, depth):
        spatial_refuse("PositionAttentionEfficient")
        bsz, h, w, _ = features.shape
        b_feat, c_feat, d_feat = self.feats(features, depth)
        attn = torch.softmax(torch.einsum("bnc,bnk->bck", d_feat, b_feat), -1)
        out = torch.einsum("bck,bnk->bnc", attn, c_feat)
        return out.reshape(bsz, h, w, -1)


class SPADE(nn.Module):
    """IN(x)·(1 + γ) + β, γ and β from convs of the depth map (resized
    nearest to x's size)."""

    def __init__(self, nf, in_channels=1, use_attention=False):
        super().__init__()
        self.attenModule = (PositionAttentionEfficient(nf, in_channels)
                            if use_attention else None)
        self.mlp_shared = nn.ModuleDict({"0": Conv(in_channels, nf, 3, 1, 1)})
        self.mlp_gamma = Conv(nf, nf, 3, 1, 1)
        self.mlp_beta = Conv(nf, nf, 3, 1, 1)

    def forward(self, x, segmap):
        if segmap.shape[1:3] != x.shape[1:3]:
            segmap = interpolate_nearest(segmap, (x.shape[1], x.shape[2]))
        if self.attenModule is not None:
            x = self.attenModule(x, segmap)
        normalized = instance_norm(x)
        actv = torch.relu(self.mlp_shared["0"](segmap, F32))
        return (normalized * (1 + self.mlp_gamma(actv, F32))
                + self.mlp_beta(actv, F32))


class DepthResidualBlockSPADE(nn.Module):
    """conv + IN → SPADE → ReLU → conv + IN → SPADE → + x → ReLU."""

    def __init__(self, nf=64, depth_ch=1, use_attention=False):
        super().__init__()
        self.conv1 = nn.ModuleDict({"0": Conv(nf, nf, 3, 1, 1)})
        self.norm1 = SPADE(nf, depth_ch, use_attention)
        self.conv2 = nn.ModuleDict({"0": Conv(nf, nf, 3, 1, 1)})
        self.norm2 = SPADE(nf, depth_ch, use_attention)

    def forward(self, x, depth_map):
        h = instance_norm(self.conv1["0"](x, F32))
        h = torch.relu(self.norm1(h, depth_map))
        h = instance_norm(self.conv2["0"](h, F32))
        return torch.relu(x + self.norm2(h, depth_map))


def _wn_stack(in_ch, out_chs, indices):
    """ModuleDict of weight-normalized 3×3 convs ``in_ch`` → out_chs[0] →
    ..., under the Sequential ``indices``."""
    chans = (in_ch,) + tuple(out_chs)
    return nn.ModuleDict({str(i): WNConv(chans[j], chans[j + 1], 3, 1, 1)
                          for j, i in enumerate(indices)})


def _head(in_nc):
    return _wn_stack(in_nc, (64, 64, 64), (0, 2, 4))


def _run_head(head, x):
    for conv in head.values():
        x = leaky_relu(conv(x, F32))
    return x


def _upscale(in_ch, mid_ch, out_ch):
    """wn-conv → PixelShuffle(2) → wn-conv (``0`` and ``3``)."""
    return nn.ModuleDict({"0": WNConv(in_ch, mid_ch * 4, 3, 1, 1),
                          "3": WNConv(mid_ch, out_ch, 3, 1, 1)})


def _run_upscale(up, x):
    h = pixel_shuffle(leaky_relu(up["0"](x, F32)), 2)
    return leaky_relu(up["3"](h, F32))


def _upscale3(tail):
    """upscale3.0 (wn 32 → 128), PixelShuffle(2), then the 9×9 output."""
    return (nn.ModuleDict({"0": WNConv(32, 128, 3, 1, 1)}),
            Conv(32, tail, 9, 1, 4))


def _run_tail(net, h):
    h = leaky_relu(pixel_shuffle(net.upscale3["0"](h, F32), 2))
    return clip(net.conv_output(h, F32), *net.clamp)


def _named(net, name, module):
    setattr(net, name.replace("_residual", "-residual"), module)


def _get(net, name):
    return getattr(net, name.replace("_residual", "-residual"))


class _Net(nn.Module):
    def init_(self, gen):
        return init_leaves_(self, gen)


class SFTMDUpscaleAfterResBlk(_Net):
    """Classic trunk at LR, then three ×2 stages (×8) with a classic block
    after the first two."""

    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=16, clamp_min=0.0,
                 clamp_max=1.0):
        super().__init__()
        self.nb, self.clamp = nb, (clamp_min, clamp_max)
        self.head = _head(in_nc)
        for i in range(nb - 3):
            _named(self, f"classic_residual{i + 1}", ClassicResidualBlock(nf))
        self.upscale1 = _upscale(64, 64, 32)
        _named(self, f"classic_residual{nb - 1}", ClassicResidualBlock(32))
        self.upscale2 = _upscale(32, 32, 32)
        _named(self, f"classic_residual{nb}", ClassicResidualBlock(32))
        self.upscale3, self.conv_output = _upscale3(out_nc)

    def forward(self, x):
        nb = self.nb
        fea_bef = _run_head(self.head, x)
        fea_in = fea_bef
        for i in range(nb - 3):
            fea_in = _get(self, f"classic_residual{i + 1}")(fea_in, F32)
        up1 = _run_upscale(self.upscale1, fea_in + fea_bef)
        up1 = _get(self, f"classic_residual{nb - 1}")(up1, F32)
        up2 = _run_upscale(self.upscale2, up1)
        up2 = _get(self, f"classic_residual{nb}")(up2, F32)
        return _run_tail(self, up2)


class SFTMDUpscaleAfterResBlkDepthCondition(_Net):
    """×8; a 3-conv depth branch gives a 64-channel conditioning map that
    the SPADE blocks ``which_resblk_depth`` (0-based) take; the others are
    classic. Blocks past nb−3 are 32 wide."""

    def __init__(self, which_resblk_depth=(), in_nc=3, out_nc=3, nf=64,
                 nb=16, clamp_min=0.0, clamp_max=1.0):
        super().__init__()
        self.nb, self.clamp = nb, (clamp_min, clamp_max)
        self.which = set(which_resblk_depth)
        self.head = _head(in_nc)
        self.depth_condition = _wn_stack(1, (64, 64, 64), (0, 2, 4))
        for i in list(range(nb - 3)) + [nb - 2, nb - 1]:
            ch = 32 if i > nb - 3 else nf
            if i in self.which:
                _named(self, f"depth_residual{i + 1}",
                       DepthResidualBlockSPADE(ch, depth_ch=64))
            else:
                _named(self, f"classic_residual{i + 1}", ClassicResidualBlock(ch))
        self.upscale1 = _upscale(64, 64, 32)
        self.upscale2 = _upscale(32, 32, 32)
        self.upscale3, self.conv_output = _upscale3(out_nc)

    def _block(self, i, feat, depth_feat):
        if i in self.which:
            return _get(self, f"depth_residual{i + 1}")(feat, depth_feat)
        return _get(self, f"classic_residual{i + 1}")(feat, F32)

    def forward(self, x, depth):
        nb = self.nb
        fea_bef = _run_head(self.head, x)
        depth_feat = _run_head(self.depth_condition, depth)
        fea_in = fea_bef
        for i in range(nb - 3):
            fea_in = self._block(i, fea_in, depth_feat)
        up1 = self._block(nb - 2, _run_upscale(self.upscale1, fea_in + fea_bef),
                          depth_feat)
        up2 = self._block(nb - 1, _run_upscale(self.upscale2, up1), depth_feat)
        return _run_tail(self, up2)


class _DepthUpscale(_Net):
    """Learned ×2 depth upsampler: wn-conv, a classic block, wn-conv →
    PixelShuffle(2), 9×9 conv, sigmoid."""

    def __init__(self, nf=64):
        super().__init__()
        self.c0 = WNConv(1, nf, 3, 1, 1)
        self.res = ClassicResidualBlock(nf)
        self.up = WNConv(nf, nf * 4, 3, 1, 1)
        self.out = Conv(nf, 1, 9, 1, 4)

    def forward(self, d):
        h = self.res(leaky_relu(self.c0(d, F32)), F32)
        h = leaky_relu(pixel_shuffle(self.up(h, F32), 2))
        return torch.sigmoid(self.out(h, F32))


class SFTMDUpscaleAfterResBlkDepth(_Net):
    """×8 with ``n_depth_resblk`` (0–3) trailing SPADE blocks on the depth
    map: at LR (block nb−3), after the first ×2 (nb−1) and after the
    second (nb). With ``pred_depth`` the depth map of the last two comes
    from learned upsamplers and ``forward`` returns (SR, depth ×4, depth
    ×2) — ×4 and ×2 below the output, as the reference names them; the
    reference applies its first upsampler's twin to the first's output."""

    def __init__(self, pred_depth=False, n_depth_resblk=3,
                 use_attention=False, in_nc=3, out_nc=3, nf=64, nb=16,
                 clamp_min=0.0, clamp_max=1.0):
        super().__init__()
        self.nb, self.clamp = nb, (clamp_min, clamp_max)
        self.pred_depth, self.n = bool(pred_depth), int(n_depth_resblk)
        n = self.n
        self.head = _head(in_nc)
        for i in range(nb - 4):
            _named(self, f"classic_residual{i + 1}", ClassicResidualBlock(nf))

        def block(idx, ch, depth):
            if depth:
                _named(self, f"depth_residual{idx}",
                       DepthResidualBlockSPADE(ch, 1, use_attention))
            else:
                _named(self, f"classic_residual{idx}", ClassicResidualBlock(ch))

        block(nb - 3, nf, n >= 1)
        self.upscale1 = _upscale(64, 64, 32)
        if n >= 2 and self.pred_depth:
            self.depth_upscale1 = _DepthUpscale()
        block(nb - 1, 32, n >= 2)
        self.upscale2 = _upscale(32, 32, 32)
        if n >= 3 and self.pred_depth:
            self.depth_upscale1_x2 = _DepthUpscale()
        block(nb, 32, n >= 3)
        self.upscale3, self.conv_output = _upscale3(out_nc)

    def forward(self, x, depth):
        nb, n = self.nb, self.n
        fea_bef = _run_head(self.head, x)
        fea_in = fea_bef
        for i in range(nb - 4):
            fea_in = _get(self, f"classic_residual{i + 1}")(fea_in, F32)
        if n >= 1:
            fea_in = _get(self, f"depth_residual{nb - 3}")(fea_in, depth)
        else:
            fea_in = _get(self, f"classic_residual{nb - 3}")(fea_in, F32)
        up1 = _run_upscale(self.upscale1, fea_in + fea_bef)
        depth_x4 = depth_x2 = None
        if n >= 2:
            depth_x4 = self.depth_upscale1(depth) if self.pred_depth else depth
            up1 = _get(self, f"depth_residual{nb - 1}")(up1, depth_x4)
        else:
            up1 = _get(self, f"classic_residual{nb - 1}")(up1, F32)
        up2 = _run_upscale(self.upscale2, up1)
        if n >= 3:
            depth_x2 = (self.depth_upscale1_x2(depth_x4) if self.pred_depth
                        else depth)
            up2 = _get(self, f"depth_residual{nb}")(up2, depth_x2)
        else:
            up2 = _get(self, f"classic_residual{nb}")(up2, F32)
        out = _run_tail(self, up2)
        if self.pred_depth:
            return out, depth_x4, depth_x2
        return out


class SFTMDNoKernel(_Net):
    """Kernel-free SFTMD: weight-normalized head, classic trunk,
    ``conv_mid``, then the scale's PixelShuffle stages (×8: three
    weight-normalized; ×4: two plain; ×2 / ×3: one)."""

    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=16, scale=4,
                 clamp_min=0.0, clamp_max=1.0):
        super().__init__()
        self.nb, self.scale, self.clamp = nb, int(scale), (clamp_min, clamp_max)
        self.head = _head(in_nc)
        for i in range(nb):
            _named(self, f"classic_residual{i + 1}", ClassicResidualBlock(nf))
        self.conv_mid = nn.ModuleDict({"0": WNConv(64, 64, 3, 1, 1)})
        if self.scale == 8:
            self.ups = [(f"upscale_{3 * j}", 2) for j in range(3)]
            conv = WNConv
        elif self.scale == 4:
            self.ups = [(f"upscale_{3 * j}", 2) for j in range(2)]
            conv = Conv
        else:
            self.ups = [("upscale_0", self.scale)]
            conv = Conv
        for name, r in self.ups:
            setattr(self, name, conv(64, 64 * r * r, 3, 1, 1))
        self.conv_output = Conv(64, out_nc, 9, 1, 4)

    def forward(self, x):
        fea_bef = _run_head(self.head, x)
        fea_in = fea_bef
        for i in range(self.nb):
            fea_in = _get(self, f"classic_residual{i + 1}")(fea_in, F32)
        fea = leaky_relu(self.conv_mid["0"](fea_in + fea_bef, F32))
        for name, r in self.ups:
            fea = leaky_relu(pixel_shuffle(getattr(self, name)(fea, F32), r))
        return clip(self.conv_output(fea, F32), *self.clamp)
