"""DepthNet ×8 — the flagship generator's serving forward in the port.

Counterpart of ``endosr/nn/depthnet.py``, default fast path only:

  Encoder (5 weight-norm convs) → region-wise masked pooling into the
  [B,K,L] style matrix → two head convs → 13 depth-guided residual blocks
  whose SEAN modulations come from the lazy hoisted branches, one
  ``style_blend_dot`` per group of ``style_chunk`` blocks → global skip →
  phase-packed up1 chain (``packed_g123``) → phase-packed tail chain
  (``packed_g123`` with ``phases``/``pre_act``/``pre_bias``) → folded head
  (``head_dot``) → ``output_stage_x8``.

Activations are NHWC; depth masks [B,H,W,K]; the style matrix [B,K,L].
Parameter names follow the reference PyTorch checkpoint
(``depth-residual3.norm1.mlp_mask.0.weight``, ``head.0.weight_v``, ...).
Other scales, presets, ``valid_hw`` and precisions are still to be ported
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from endosr_torch.kernels.head_dot import head_dot
from endosr_torch.kernels.output_stage import embed_head_channels, output_stage_x8
from endosr_torch.kernels.packed_chain import packed_g123
from endosr_torch.nn.layers import (
    Conv,
    WNConv,
    WNConvTranspose,
    chained_instance_norm,
    conv2d_nhwc,
    fold_kernel_through_pixel_shuffle,
    hwio,
    leaky_relu,
    packed_stage_kernel,
    wn_effective_kernel,
)
from endosr_torch.nn.sean import (
    SEAN,
    o_branch_raw_hwnc,
    precompute_o_actv,
    precompute_style_v,
    shifted_mask_stack,
    style_blend_chunk,
)
from endosr_torch.ops.resize import interpolate_bilinear, interpolate_nearest
from endosr_torch.utils.device import device_constant

__all__ = ["DepthNet", "Encoder", "region_wise_avg_pooling",
           "DepthResidualBlock", "ClassicResidualBlock"]


def _fold_wb(w, b, r):
    """Fold an fp32 (HWIO kernel, bias) through a pending pixel_shuffle(r)."""
    if r == 1:
        return w, b
    return fold_kernel_through_pixel_shuffle(w, r), b.repeat_interleave(r * r)


def _head_perm(fs: int) -> np.ndarray:
    """Head input channels from canonical PS(2·fs) order to the packed
    tail's group-major order ((α·2+β)·32fs² + c·fs² + g·fs + h)."""
    rt = 2 * fs
    c32, gg = np.arange(32), np.arange(fs)
    return np.concatenate([
        (c32[:, None, None] * rt * rt + (a * fs + gg[:, None]) * rt
         + (b * fs + gg[None, :])).ravel()
        for a in (0, 1) for b in (0, 1)])


def region_wise_avg_pooling(feature_map, mask):
    """Masked average pool [B,h,w,L] × [B,H,W,K] → [B,K,L]; a mask of
    another resolution is bilinear-resized (align_corners) and re-binarized
    at 0.5 first."""
    fh, fw = feature_map.shape[1], feature_map.shape[2]
    if mask.shape[1] != fh or mask.shape[2] != fw:
        mask = interpolate_bilinear(mask, (fh, fw), align_corners=True)
        mask = (mask >= 0.5).to(feature_map.dtype)
    mask = mask.to(feature_map.dtype)
    sum_feat = torch.einsum("bhwk,bhwl->bkl", mask, feature_map)
    sum_mask = mask.sum(dim=(1, 2))
    return sum_feat / (sum_mask[..., None] + 1e-10)


class Encoder(nn.Module):
    """Depth-matrix encoder: (stride-1 32-ch trunk feature, [B,K,L] style
    matrix)."""

    def __init__(self, in_nc=3, latent_ch=256, device=None):
        super().__init__()
        self.layer1 = WNConv(in_nc, 32, 3, 1, 1, device=device)
        self.layer2 = WNConv(32, 64, 3, 2, 1, device=device)
        self.layer3 = WNConv(64, 128, 3, 2, 1, device=device)
        self.layer4 = WNConvTranspose(128, latent_ch, 3, 2, 1, device=device)
        self.layer5 = WNConv(latent_ch, latent_ch, 3, 2, 1, device=device)

    def forward(self, x, depth_mask, dtype):
        feat = self.layer1(x, dtype)
        out = self.layer2(leaky_relu(feat), dtype)
        out = self.layer3(leaky_relu(out), dtype)
        out = self.layer4(leaky_relu(out), dtype)
        out = self.layer5(leaky_relu(out), dtype)
        return leaky_relu(feat), region_wise_avg_pooling(out, depth_mask)


class DepthResidualBlock(nn.Module):
    """conv + IN → SEAN → ReLU → conv + IN → SEAN → +res → ReLU, with both
    norms chained into one statistics pass and the SEAN modulations given."""

    def __init__(self, nf=64, depth_latent_ch=256, depth_range_num=10,
                 use_trainable_params=True, norm_gamma=0.1, norm_beta=0.1,
                 device=None):
        super().__init__()
        kw = dict(label_nc=depth_range_num, norm_nc=nf,
                  len_latent=depth_latent_ch,
                  use_trainable_params=use_trainable_params,
                  norm_gamma=norm_gamma, norm_beta=norm_beta, device=device)
        self.conv1 = nn.ModuleDict({"0": Conv(nf, nf, 3, device=device)})
        self.norm1 = SEAN(**kw)
        self.conv2 = nn.ModuleDict({"0": Conv(nf, nf, 3, device=device)})
        self.norm2 = SEAN(**kw)

    def init_(self, gen):
        for m in (self.conv1["0"], self.norm1, self.conv2["0"], self.norm2):
            m.init_(gen)

    def forward(self, x, mod, dtype):
        h = chained_instance_norm(self.conv1["0"](x, dtype))
        h = torch.relu(self.norm1(h, mod[0]))
        h = chained_instance_norm(self.conv2["0"](h, dtype))
        h = self.norm2(h, mod[1])
        return torch.relu(x + h)


class ClassicResidualBlock(nn.Module):
    """wn-conv → ReLU → wn-conv → +res → ReLU; on the ported path both
    classic blocks sit in the packed chains, which use their effective
    weights."""

    def __init__(self, nf=64, device=None):
        super().__init__()
        self.block = nn.ModuleDict({"0": WNConv(nf, nf, 3, device=device),
                                    "2": WNConv(nf, nf, 3, device=device)})

    def init_(self, gen):
        self.block["0"].init_(gen)
        self.block["2"].init_(gen)

    def effective_weights(self):
        """fp32 ((w0, b0), (w2, b2)) effective HWIO kernels."""
        return (wn_effective_kernel(self.block["0"]),
                wn_effective_kernel(self.block["2"]))


class DepthNet(nn.Module):
    """The ×8 DepthNet serving forward (default fields of the JAX module:
    lazy branches, blend-fused style groups, packed up1 chain and tail,
    tap-stacked head and the v3 output stage)."""

    def __init__(self, which_resblk_depth=tuple(range(14)), in_nc=3, out_nc=3,
                 nf=64, nb=16, scale=8, clamp_min=0.0, clamp_max=1.0,
                 depth_latent_ch=256, depth_range_num=10,
                 use_trainable_params=True, norm_gamma=0.1, norm_beta=0.1,
                 style_chunk=7, dtype=torch.float32, device=None):
        super().__init__()
        which = set(which_resblk_depth)
        if scale != 8:
            raise NotImplementedError(
                f"scale {scale}: only the ×8 packed tail is ported")
        if not which:
            raise NotImplementedError("the baseline (no depth blocks) path "
                                      "is not ported")
        if (nb - 2) in which or (nb - 1) in which:
            raise NotImplementedError("depth blocks after upscale1 need the "
                                      "unfolded tail, which is not ported")
        if any(i not in which for i in range(nb - 3)):
            raise NotImplementedError("classic blocks in the trunk are not "
                                      "ported")
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"precision {dtype} is not ported")
        self.nb, self.out_nc = nb, out_nc
        self.clamp_min, self.clamp_max = clamp_min, clamp_max
        self.style_chunk = max(1, int(style_chunk))
        self.dtype = dtype
        num_last_block = int(math.log2(scale))

        self.encoder = Encoder(in_nc, depth_latent_ch, device=device)
        self.head = nn.ModuleDict({"0": WNConv(32, 64, 3, device=device),
                                   "2": WNConv(64, 64, 3, device=device)})
        self.block_names = {}
        for i in [*range(nb - 3), nb - 2, nb - 1]:
            ch = 32 if i > nb - num_last_block else nf
            if i in which:
                name = f"depth-residual{i + 1}"
                blk = DepthResidualBlock(ch, depth_latent_ch, depth_range_num,
                                         use_trainable_params, norm_gamma,
                                         norm_beta, device=device)
            else:
                name = f"classic-residual{i + 1}"
                blk = ClassicResidualBlock(ch, device=device)
            self.add_module(name, blk)
            self.block_names[i] = name
        self.upscale1 = nn.ModuleDict({"0": WNConv(64, 256, 3, device=device),
                                       "3": WNConv(64, 32, 3, device=device)})
        self.upscale2 = nn.ModuleDict({"0": WNConv(32, 128, 3, device=device),
                                       "3": WNConv(32, 32, 3, device=device)})
        self.upscale3 = nn.ModuleDict({"0": WNConv(32, 128, 3, device=device)})
        self.conv_output = Conv(32, out_nc, 9, padding=4, device=device)

    def block(self, i):
        return getattr(self, self.block_names[i])

    def init_(self, gen: torch.Generator):
        """Seeded init with the shapes and distributions of the JAX
        module's init (torch Conv2d default bounds, g = ‖v‖, α ~ U[0,1))."""
        for m in (*self.encoder.children(), *self.head.values()):
            m.init_(gen)
        for i in sorted(self.block_names):
            self.block(i).init_(gen)
        for m in (*self.upscale1.values(), *self.upscale2.values(),
                  *self.upscale3.values(), self.conv_output):
            m.init_(gen)
        return self

    @torch.inference_mode()
    def forward(self, x, depth_map, depth_mask):
        """x [B,H,W,3], depth_map [B,H,W,1], depth_mask [B,H,W,K] →
        [B,8H,8W,3] fp32 in [clamp_min, clamp_max]."""
        dt, nb = self.dtype, self.nb
        feat, depth_vec = self.encoder(x, depth_mask, dt)
        fea_bef = leaky_relu(self.head["2"](
            leaky_relu(self.head["0"](feat, dt)), dt))
        fea_in = fea_bef

        trunk_depth = list(range(nb - 3))
        size = (feat.shape[1], feat.shape[2])
        dmap = interpolate_nearest(depth_map, size)
        dmask = interpolate_nearest(depth_mask, size)
        o_w, s_w = [], []
        for i in trunk_depth:
            blk = self.block(i)
            o_w += [blk.norm1.depth_branch_weights(),
                    blk.norm2.depth_branch_weights()]
            s_w += [blk.norm1.style_branch_weights(),
                    blk.norm2.style_branch_weights()]
        actv = precompute_o_actv(o_w, dmap, dt)
        shifted = shifted_mask_stack(dmask, dt)
        v_chunks = precompute_style_v(s_w, depth_vec, dt)
        g = self.style_chunk
        groups = {grp[0]: grp for grp in (trunk_depth[j:j + g]
                                          for j in range(0, len(trunk_depth), g))}
        slot = {i: k for k, i in enumerate(trunk_depth)}
        mods = {}

        for i in range(nb - 3):
            if i in groups:
                mods.update(self._group_mods(groups[i], slot, actv, o_w, s_w,
                                             v_chunks, shifted))
            fea_in = self.block(i)(fea_in, mods.pop(i), dt)
        return self._packed_up1_and_tail(fea_in + fea_bef)

    def _group_mods(self, ids, slot, actv, o_w, s_w, v_chunks, shifted):
        """Final (γ, β) of both SEANs of every block in ``ids`` through one
        ``style_blend_dot``."""
        dt = self.dtype
        v_list, w_list, a_list, ob_list, convs = [], [], [], [], []
        for i in ids:
            blk = self.block(i)
            for half, norm in enumerate((blk.norm1, blk.norm2)):
                k = 2 * slot[i] + half
                al = norm.blend_alphas()
                v_list.append(v_chunks[k])
                w_list.append(s_w[k])
                a_list.append(al)
                ob_list.append(o_w[k][3])
                convs.append(o_branch_raw_hwnc(actv[k], o_w[k], dt, al))
        outs = style_blend_chunk(shifted, v_list, w_list, a_list, ob_list,
                                 convs, dt)
        return {i: (outs[2 * n], outs[2 * n + 1]) for n, i in enumerate(ids)}

    def _packed_up1_and_tail(self, feat_add1):
        """upscale1 → block nb-2 → upscale2_0 as the packed up1 chain on the
        (LR+1)² grid, then the packed tail, head and output stage."""
        dt, nb = self.dtype, self.nb
        psk = packed_stage_kernel
        h_pre = self.upscale1["0"](feat_add1, dt)
        w13, b13 = wn_effective_kernel(self.upscale1["3"])
        (w50, b50), (w52, b52) = self.block(nb - 2).effective_weights()
        w20, b20 = wn_effective_kernel(self.upscale2["0"])
        g3 = packed_g123(
            h_pre.permute(1, 2, 0, 3),
            psk(w13, 0, 1, in_interleaved=True), b13.repeat(4),
            psk(w50, 1, 0), b50.repeat(4), psk(w52, 0, 1), b52.repeat(4),
            pre_act=True).permute(2, 0, 1, 3)
        # stage 4 runs raw: its bias and leaky_relu are deferred into the
        # tail chain's load (pre_bias / pre_act)
        g4 = conv2d_nhwc(g3, psk(w20, 1, 0), ((0, 1), (0, 1)), dt)
        return self._packed_tail(g4, b20)

    def _packed_tail(self, z_g4, pre_bias):
        """upscale2_3, block nb-1 and upscale3_0 on the phase-packed grid of
        the packed up1 output ``z_g4`` [B, N+1, N+1, 512] (fine grid 2N²),
        then the folded 9×9 head and the output stage."""
        dt = self.dtype
        psk = packed_stage_kernel
        nw = 2 * (z_g4.shape[2] - 1)
        fs, rt = 2, 4
        w23, b23 = wn_effective_kernel(self.upscale2["3"])
        (wc0, bc0), (wc2, bc2) = self.block(self.nb - 1).effective_weights()
        g3 = packed_g123(
            z_g4.permute(1, 2, 0, 3),
            psk(w23, 0, 1, in_interleaved=True), b23.repeat(4),
            psk(wc0, 1, 0), bc0.repeat(4), psk(wc2, 0, 1), bc2.repeat(4),
            pre_act=True, pre_bias=pre_bias.to(dt),
            phases=True).permute(2, 0, 1, 3)
        w30, b30 = wn_effective_kernel(self.upscale3["0"])
        # raw conv: its bias + leaky_relu and the s=0 gate run inside head_dot
        g4 = conv2d_nhwc(g3, psk(w30, 1, 0), ((0, 1), (0, 1)), dt)
        # head folded by rt, input channels permuted from canonical PS(rt)
        # order to g4's group-major packed order
        wh, bh = _fold_wb(hwio(self.conv_output.weight).float(),
                          self.conv_output.bias.float(), rt)
        perm = device_constant(_head_perm, (fs,), torch.int64, wh.device)
        w64, b64 = embed_head_channels(wh[:, :, perm, :], bh)
        pre64 = head_dot(g4.permute(1, 2, 0, 3), w64.to(dt), b64, nw,
                         b30.repeat(4).to(dt))                 # [H, B, W, 64]
        flat = output_stage_x8(pre64, self.clamp_min, self.clamp_max,
                               order="hbwc")
        return flat.reshape(flat.shape[0], flat.shape[1], -1, self.out_nc)
