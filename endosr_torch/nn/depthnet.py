"""DepthNet — the flagship generator's serving forward in the port.

Counterpart of ``endosr/nn/depthnet.py`` with its default fields, at every
scale (×2, ×3, ×4, ×8):

  Encoder (5 weight-norm convs) → region-wise masked pooling into the
  [B,K,L] style matrix → two head convs → the trunk's residual blocks,
  whose SEAN modulations come from the lazy hoisted branches, one group of
  ``style_chunk`` blocks at a time → global skip → the scale's tail →
  9×9 head → clamp → fp32.

Unmasked, a style group is one ``style_blend_dot`` and the ×8 tail is the
phase-packed one: up1 chain (``packed_g123``) → tail chain
(``packed_g123`` with ``phases``/``pre_act``/``pre_bias``) → folded head
(``head_dot``) → ``output_stage_x8``. With ``valid_hw`` (exact bucketed
eval: inputs zero-padded to a bucket shape, every stream re-zeroed outside
the valid region before each conv, InstanceNorm statistics over the valid
region, styles pooled with ``pool_mask``) a style group is one
``style_dot_hwbm``, the ×8 tail runs as dense folds, and every scale ends
in ``output_stage``. ×2/×3/×4 always run the folded tail (``_folded_head``,
at ×4 phase-split and ending in ``output_stage_x8`` when unmasked).
``fused_epilogue`` normalizes and modulates in the ``fused_in_mod`` kernel
and ``in_stats="kernel"`` takes the block InstanceNorm's sums from the
``in_stats`` kernel.

Activations are NHWC; depth masks [B,H,W,K]; the style matrix [B,K,L].
Parameter names follow the reference PyTorch checkpoint
(``depth-residual3.norm1.mlp_mask.0.weight``, ``head.0.weight_v``, ...).
The baseline without depth blocks, a depth block at nb-1 for scale ≥ 4
(the unfolded tail), the ablations and precisions other than fp32/bf16 are
still to be ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn

from endosr_torch.kernels.head_dot import head_dot
from endosr_torch.kernels.output_stage import (embed_head_channels,
                                               output_stage, output_stage_x8)
from endosr_torch.kernels.packed_chain import packed_g123
from endosr_torch.nn.layers import (
    Conv,
    WNConv,
    WNConvTranspose,
    chained_instance_norm,
    compose_pixel_shuffle_perm,
    conv2d_nhwc,
    fold_kernel_through_pixel_shuffle,
    hwio,
    instance_norm,
    leaky_relu,
    masked_chained_instance_norm,
    masked_instance_norm,
    packed_stage_kernel,
    pixel_shuffle,
    valid_mask,
    wn_effective_kernel,
)
from endosr_torch.nn.sean import (
    SEAN,
    o_branch_from_actv,
    o_branch_raw_hwnc,
    precompute_o_actv,
    precompute_style_v,
    shifted_mask_stack,
    style_blend_chunk,
    style_chunk_dot,
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


def _phase_channels(fs: int) -> np.ndarray:
    """[4, 32·fs²]: the canonical PS(2·fs) channels owned by the pending
    PS(2) phase (a, b), for (a, b) = (0,0), (0,1), (1,0), (1,1). Flattened,
    it maps canonical order to the packed tail's group-major order
    ((a·2+b)·32fs² + c·fs² + g·fs + h)."""
    rt = 2 * fs
    c32, gg = np.arange(32), np.arange(fs)
    return np.stack([
        (c32[:, None, None] * rt * rt + (a * fs + gg[:, None]) * rt
         + (b * fs + gg[None, :])).ravel()
        for a in (0, 1) for b in (0, 1)])


def _phase_gate(hn: int, wn: int) -> np.ndarray:
    """[1, hn+1, wn+1, 4, 1] 0/1 gate of the phase-split head's wide conv:
    phase (a, b)'s map is dead at row hn (a = 0) or row 0 (a = 1), and
    likewise along the columns with b."""
    y, x = np.arange(hn + 1), np.arange(wn + 1)
    rows = [(y != hn), (y != 0)]
    cols = [(x != wn), (x != 0)]
    g = np.stack([rows[a][:, None] & cols[b][None, :]
                  for a in (0, 1) for b in (0, 1)], axis=-1)
    return g.astype(np.float32)[None, ..., None]


def _mul(t, m):
    """t·m in t's dtype (a bf16 stream times an fp32 mask would promote)."""
    return t if m is None else t * m.to(t.dtype)


def _conv_b(x, w, b, dtype):
    """SAME conv of NHWC ``x`` with an fp32 (HWIO kernel, bias) in ``dtype``."""
    return conv2d_nhwc(x, w, w.shape[0] // 2, dtype) + b.to(dtype)


class _ValidRegion:
    """The valid region of a zero-padded input (exact bucketed eval): rows
    < hv and columns < wv of the padded [hp, wp] grid, scaled with a
    tensor's resolution. Without ``valid_hw`` every method is a no-op."""

    def __init__(self, x, valid_hw):
        self.on = valid_hw is not None
        if self.on:
            self.hv, self.wv = int(valid_hw[0]), int(valid_hw[1])
            self.hp, self.wp = x.shape[1], x.shape[2]
            self.vm = valid_mask((self.hp, self.wp), self.hv, self.wv,
                                 device=x.device)

    def mask_for(self, t):
        """The [1,H,W,1] mask at ``t``'s resolution, or None."""
        if not self.on:
            return None
        rh, rw = t.shape[1] // self.hp, t.shape[2] // self.wp
        if (rh, rw) == (1, 1):
            return self.vm
        return valid_mask((t.shape[1], t.shape[2]), self.hv * rh, self.wv * rw,
                          device=t.device)

    def zero(self, t):
        """``t`` re-zeroed outside the valid region."""
        return _mul(t, self.mask_for(t))


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

    def forward(self, x, depth_mask, dtype, valid_hw=None, pool_mask=None):
        """``valid_hw`` = (hv, wv): every conv input is re-zeroed outside
        the valid region of its resolution, and the styles are pooled with
        ``pool_mask`` (the host-resized depth mask, zero-padded to the
        latent's shape; see ``ops.masks.pool_mask_np``)."""
        m1 = m2 = m3 = m4 = None
        if valid_hw is not None:
            hv, wv = valid_hw
            h, w = x.shape[1], x.shape[2]
            v2h, v2w = (hv + 1) // 2, (wv + 1) // 2      # after stride 2
            v3h, v3w = (v2h + 1) // 2, (v2w + 1) // 2    # after stride 2
            vm = functools.partial(valid_mask, device=x.device)
            m1 = vm((h, w), hv, wv)
            m2 = vm((h // 2, w // 2), v2h, v2w)
            m3 = vm((h // 4, w // 4), v3h, v3w)
            # the transposed conv gives 2n − 1
            m4 = vm((h // 2 - 1, w // 2 - 1), 2 * v3h - 1, 2 * v3w - 1)
        feat = self.layer1(x, dtype)
        out = self.layer2(_mul(leaky_relu(feat), m1), dtype)
        out = self.layer3(_mul(leaky_relu(out), m2), dtype)
        out = self.layer4(_mul(leaky_relu(out), m3), dtype)
        out = self.layer5(_mul(leaky_relu(out), m4), dtype)
        style = region_wise_avg_pooling(
            out, depth_mask if pool_mask is None else pool_mask)
        return _mul(leaky_relu(feat), m1), style


class DepthResidualBlock(nn.Module):
    """conv + IN → SEAN → ReLU → conv + IN → SEAN → +res → ReLU. The block's
    norm and the SEAN's parameter-free norm chain into one statistics pass,
    except under ``fused_epilogue``, where the block's norm is a plain
    ``instance_norm`` (sums from the ``in_stats`` kernel with
    ``in_stats="kernel"``) and the SEAN normalizes and modulates in the
    ``fused_in_mod`` kernel."""

    def __init__(self, nf=64, depth_latent_ch=256, depth_range_num=10,
                 use_trainable_params=True, norm_gamma=0.1, norm_beta=0.1,
                 fused_epilogue=False, in_stats="default", device=None):
        super().__init__()
        self.fused_epilogue, self.in_stats = bool(fused_epilogue), in_stats
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

    def forward(self, x, dtype, depth, ob=None, sb=None, mod=None, vmask=None):
        """``depth`` = (depth_map, depth_mask, style matrix); ``ob``/``sb``/
        ``mod``: per-SEAN pairs of precomputed modulations (see
        :meth:`SEAN.forward`); ``vmask``: valid-region mask of exact
        bucketed eval."""
        chain = not self.fused_epilogue
        if vmask is None:
            norm = (chained_instance_norm if chain else
                    functools.partial(instance_norm, stats=self.in_stats))
        else:
            norm = functools.partial(
                masked_chained_instance_norm if chain else masked_instance_norm,
                vmask=vmask)

        def pick(pair, k):
            return None if pair is None else pair[k]

        kw = dict(pre_normalized=chain, vmask=vmask,
                  fused_epilogue=self.fused_epilogue)
        h = norm(self.conv1["0"](x, dtype))
        h = torch.relu(self.norm1(h, *depth, dtype, ob=pick(ob, 0),
                                  sb=pick(sb, 0), mod=pick(mod, 0), **kw))
        h = norm(self.conv2["0"](h, dtype))
        h = self.norm2(h, *depth, dtype, ob=pick(ob, 1), sb=pick(sb, 1),
                       mod=pick(mod, 1), **kw)
        return torch.relu(x + h)


class ClassicResidualBlock(nn.Module):
    """wn-conv → ReLU → wn-conv → +res → ReLU. Between upscale stages the
    tails use its effective weights (folded or phase-packed) instead of
    calling it."""

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

    def forward(self, x, dtype, vmask=None):
        h = _mul(torch.relu(self.block["0"](x, dtype)), vmask)
        return _mul(torch.relu(x + self.block["2"](h, dtype)), vmask)


class DepthNet(nn.Module):
    """The DepthNet serving forward with the JAX module's default fields
    (lazy branches, blend-fused or masked style groups, folded tails, the
    packed ×8 tail when unmasked, kernel output stages)."""

    def __init__(self, which_resblk_depth=tuple(range(14)), in_nc=3, out_nc=3,
                 nf=64, nb=16, scale=4, clamp_min=0.0, clamp_max=1.0,
                 depth_latent_ch=256, depth_range_num=10,
                 use_trainable_params=True, norm_gamma=0.1, norm_beta=0.1,
                 fused_epilogue=False, in_stats="default", style_chunk=7,
                 dtype=torch.float32, device=None):
        super().__init__()
        which = set(which_resblk_depth)
        if scale not in (2, 3, 4, 8):
            raise NotImplementedError(f"scale {scale} is not ported")
        if not which:
            raise NotImplementedError("the baseline (no depth blocks) path "
                                      "is not ported")
        if scale >= 4 and (nb - 1) in which:
            raise NotImplementedError(
                "a depth block after upscale2 needs the unfolded tail, which "
                "is not ported")
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"precision {dtype} is not ported")
        if in_stats not in ("default", "kernel"):
            raise ValueError(f"in_stats must be 'default' or 'kernel', got "
                             f"{in_stats!r}")
        self.which, self.scale = which, scale
        self.nb, self.out_nc = nb, out_nc
        self.clamp_min, self.clamp_max = clamp_min, clamp_max
        self.fused_epilogue = bool(fused_epilogue)
        self.style_chunk = max(1, int(style_chunk))
        self.dtype = dtype
        # ×8: the trailing 2 blocks at 32 ch; ×4: 1; ×2/×3: all at nf
        num_last_block = 1 if scale == 3 else int(math.log2(scale))
        self.final_scale = fs = 3 if scale == 3 else 2

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
                                         norm_beta, self.fused_epilogue,
                                         in_stats, device=device)
            else:
                name = f"classic-residual{i + 1}"
                blk = ClassicResidualBlock(ch, device=device)
            self.add_module(name, blk)
            self.block_names[i] = name
        if scale == 8:
            self.upscale1 = nn.ModuleDict(
                {"0": WNConv(64, 256, 3, device=device),
                 "3": WNConv(64, 32, 3, device=device)})
        if scale >= 4:
            self.upscale2 = nn.ModuleDict(
                {"0": WNConv(32 if scale == 8 else nf, 128, 3, device=device),
                 "3": WNConv(32, 32, 3, device=device)})
        self.upscale3 = nn.ModuleDict(
            {"0": WNConv(32 if scale >= 4 else nf, 32 * fs * fs, 3,
                         device=device)})
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
        for name in ("upscale1", "upscale2", "upscale3"):
            for m in getattr(self, name, {}).values():
                m.init_(gen)
        self.conv_output.init_(gen)
        return self

    @torch.inference_mode()
    def forward(self, x, depth_map, depth_mask, valid_hw=None, pool_mask=None):
        """x [B,H,W,3], depth_map [B,H,W,1], depth_mask [B,H,W,K] →
        [B,s·H,s·W,3] fp32 in [clamp_min, clamp_max].

        ``valid_hw`` = (hv, wv), plain ints: exact bucketed eval of inputs
        zero-padded to H, W (multiples of 4) with ``pool_mask`` from
        ``ops.masks.pool_mask_np``; the [:hv·s, :wv·s] crop of the output
        equals the forward of the unpadded input up to fp32 summation
        order."""
        dt, nb = self.dtype, self.nb
        if valid_hw is not None and self.fused_epilogue:
            raise ValueError("exact bucketed eval (valid_hw) does not support "
                             "the fused epilogue")
        vr = _ValidRegion(x, valid_hw)
        feat, depth_vec = self.encoder(x, depth_mask, dt, valid_hw, pool_mask)
        fea = vr.zero(leaky_relu(self.head["0"](feat, dt)))
        fea_bef = vr.zero(leaky_relu(self.head["2"](fea, dt)))
        fea_in = fea_bef
        depth = (depth_map, depth_mask, depth_vec)

        trunk_depth = [i for i in range(nb - 3) if i in self.which]
        groups, slot = {}, {}
        if trunk_depth:
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
            actv = precompute_o_actv(o_w, dmap, dt, vr.mask_for(dmap))
            shifted = shifted_mask_stack(dmask, dt)
            v_chunks = precompute_style_v(s_w, depth_vec, dt)
            g = self.style_chunk
            groups = {grp[0]: grp for grp in (
                trunk_depth[j:j + g] for j in range(0, len(trunk_depth), g))}
            slot = {i: k for k, i in enumerate(trunk_depth)}
        mods = {}

        for i in range(nb - 3):
            if i in groups:
                mods.update(self._group_mods(groups[i], slot, actv, o_w, s_w,
                                             v_chunks, shifted, vr.on))
            kw = mods.pop(i, {})
            if "sb" in kw:   # masked path: the o-branch conv2 runs per block
                kw["ob"] = tuple(
                    o_branch_from_actv(actv[2 * slot[i] + half],
                                       o_w[2 * slot[i] + half], dt)
                    for half in (0, 1))
            fea_in = self._run_block(i, fea_in, depth, vr, **kw)
        feat_add1 = fea_in + fea_bef                         # global skip

        if (self.scale == 8 and (nb - 2) not in self.which
                and (nb - 1) not in self.which):
            if not vr.on:
                return self._packed_up1_and_tail(feat_add1)
            return self._dense_fold1_tail(feat_add1, vr)
        return self._tail(feat_add1, depth, vr)

    def _run_block(self, i, feat, depth, vr, **kw):
        blk = self.block(i)
        if isinstance(blk, DepthResidualBlock):
            return blk(feat, self.dtype, depth, vmask=vr.mask_for(feat), **kw)
        return blk(feat, self.dtype, vmask=vr.mask_for(feat))

    def _group_mods(self, ids, slot, actv, o_w, s_w, v_chunks, shifted,
                    masked):
        """Modulations of both SEANs of every block in ``ids`` from one
        kernel launch: unmasked, the finished (γ, β) through
        ``style_blend_dot`` ({"mod": ...}); masked, where the blend cannot
        run, the style halves through ``style_dot_hwbm`` ({"sb": ...})."""
        dt = self.dtype
        ks = [2 * slot[i] + half for i in ids for half in (0, 1)]
        if masked:
            outs = style_chunk_dot(shifted, [v_chunks[k] for k in ks],
                                   [s_w[k] for k in ks], dt)
            return {i: {"sb": (outs[2 * n], outs[2 * n + 1])}
                    for n, i in enumerate(ids)}
        norms = [n for i in ids
                 for n in (self.block(i).norm1, self.block(i).norm2)]
        alphas = [n.blend_alphas() for n in norms]
        convs = [o_branch_raw_hwnc(actv[k], o_w[k], dt, al)
                 for k, al in zip(ks, alphas)]
        outs = style_blend_chunk(shifted, [v_chunks[k] for k in ks],
                                 [s_w[k] for k in ks], alphas,
                                 [o_w[k][3] for k in ks], convs, dt)
        return {i: {"mod": (outs[2 * n], outs[2 * n + 1])}
                for n, i in enumerate(ids)}

    def _folded_classic(self, blk, z, r, vr):
        """A classic block on a PS(r)-pending tensor: both convs folded."""
        dt = self.dtype
        (w0, b0), (w2, b2) = blk.effective_weights()
        t = torch.relu(_conv_b(vr.zero(z), *_fold_wb(w0, b0, r), dt))
        return torch.relu(z + _conv_b(vr.zero(t), *_fold_wb(w2, b2, r), dt))

    def _dense_fold1_tail(self, feat_add1, vr):
        """The ×8 tail of the masked forward: upscale1_3, block nb-2 and
        upscale2_0 as dense PS(2) folds at LR², one real PixelShuffle(2),
        then upscale2_3 and block nb-1 folded by 2 and the folded head."""
        dt, nb = self.dtype, self.nb
        wn = wn_effective_kernel
        h = leaky_relu(self.upscale1["0"](feat_add1, dt))
        z = leaky_relu(_conv_b(vr.zero(h), *_fold_wb(*wn(self.upscale1["3"]), 2),
                               dt))
        z = self._folded_classic(self.block(nb - 2), z, 2, vr)
        z = leaky_relu(_conv_b(vr.zero(z), *_fold_wb(*wn(self.upscale2["0"]), 2),
                               dt))
        z = pixel_shuffle(z, 2)
        z = leaky_relu(_conv_b(vr.zero(z), *_fold_wb(*wn(self.upscale2["3"]), 2),
                               dt))
        z = self._folded_classic(self.block(nb - 1), z, 2, vr)
        return self._folded_head(z, 2, vr)

    def _tail(self, feat_add1, depth, vr):
        """The tail of ×2/×3/×4 (and of ×8 with a depth block at nb-2):
        upscale1 at real resolution (×8 only), block nb-2, then every
        later PixelShuffle deferred into folded kernels."""
        dt, nb = self.dtype, self.nb
        z = feat_add1
        if self.scale == 8:
            h = pixel_shuffle(leaky_relu(self.upscale1["0"](z, dt)), 2)
            z = vr.zero(leaky_relu(self.upscale1["3"](vr.zero(h), dt)))
        z = self._run_block(nb - 2, z, depth, vr)
        r = 1
        if self.scale >= 4:
            # the conv's output channels are already in canonical PS(2) order
            z = leaky_relu(self.upscale2["0"](z, dt))
            r = 2
            w23, b23 = _fold_wb(*wn_effective_kernel(self.upscale2["3"]), r)
            z = leaky_relu(_conv_b(vr.zero(z), w23, b23, dt))
            z = self._folded_classic(self.block(nb - 1), z, r, vr)
        else:
            z = self._run_block(nb - 1, z, depth, vr)
        return self._folded_head(z, r, vr)

    def _folded_head(self, z, r, vr):
        """upscale3 + the 9×9 head with every pending shuffle deferred: ``z``
        holds PS(r)-pending features in canonical order; upscale3_0 and the
        head are folded through the pending shuffles and one output stage
        emits the clamped fp32 image. With r = 2 the folded upscale3_0 runs
        phase-split (:meth:`_phase_split_head`)."""
        dt, fs = self.dtype, self.final_scale
        vmask = vr.mask_for(z)
        w30, b30 = _fold_wb(*wn_effective_kernel(self.upscale3["0"]), r)
        # defer upscale3's shuffle too: canonical PS(r·fs) channel order
        perm = device_constant(compose_pixel_shuffle_perm,
                               (r, fs, 32 * fs * fs * r * r), torch.int64,
                               w30.device)
        w30, b30 = w30[..., perm], b30[perm]
        if r == 2:
            return self._phase_split_head(_mul(z, vmask), w30, b30, vmask)
        z = _conv_b(_mul(z, vmask), w30, b30, dt)
        rt = r * fs
        wh, bh = _fold_wb(hwio(self.conv_output.weight).float(),
                          self.conv_output.bias.float(), rt)
        pre = _conv_b(_mul(leaky_relu(z), vmask), wh, bh, dt)
        flat = output_stage(pre, rt, self.clamp_min, self.clamp_max)
        return flat.reshape(flat.shape[0], flat.shape[1], -1, self.out_nc)

    def _phase_split_head(self, z, w30, b30, vmask):
        """The r = 2 folded head: a 3×3 conv folded through PS(2) is 75 %
        structural zeros (output phase (a, b) reads taps u ∈ {a, a+1},
        v ∈ {b, b+1} only), so the dense [3,3,C,4M] upscale3_0 runs as four
        [2,2,C,M] phase convs, and the head reads the four phase tensors
        as an input-channel split of its folded conv. Unmasked the four
        are one wide conv on a pad-1 grid with per-phase border gates, and
        the ×4/×8 head (r·fs = 4, 3 colours) ends in ``output_stage_x8``;
        masked they run apart, each re-zeroed outside the valid region."""
        dt, fs = self.dtype, self.final_scale
        rt = 2 * fs
        wh, bh = _fold_wb(hwio(self.conv_output.weight).float(),
                          self.conv_output.bias.float(), rt)
        phases = [(a, b) for a in (0, 1) for b in (0, 1)]
        idxs = device_constant(_phase_channels, (fs,), torch.int64, z.device)
        m_per = 32 * fs * fs
        v3 = vmask is None and rt == 4 and self.out_nc == 3

        def head_w(idx):
            w_ab = wh[:, :, idx, :]
            return embed_head_channels(w_ab, bh)[0] if v3 else w_ab

        pre = None
        if vmask is None:
            w_all = torch.cat([w30[a:a + 2, b:b + 2][..., idx]
                               for (a, b), idx in zip(phases, idxs)], dim=-1)
            b_all = torch.cat([b30[idx] for idx in idxs])
            big = leaky_relu(conv2d_nhwc(z, w_all, 1, dt) + b_all.to(dt))
            bsz, hb, wb, _ = big.shape
            gate = device_constant(_phase_gate, (hb - 1, wb - 1), dt, z.device)
            big = (big.reshape(bsz, hb, wb, 4, m_per) * gate).reshape(big.shape)
            for k, ((a, b), idx) in enumerate(zip(phases, idxs)):
                h_ab = conv2d_nhwc(big[..., m_per * k:m_per * (k + 1)],
                                   head_w(idx), ((1 - a, a), (1 - b, b)), dt)
                pre = h_ab if pre is None else pre + h_ab
        else:
            for (a, b), idx in zip(phases, idxs):
                zp = conv2d_nhwc(z, w30[a:a + 2, b:b + 2][..., idx],
                                 ((1 - a, a), (1 - b, b)), dt) + b30[idx].to(dt)
                h_ab = conv2d_nhwc(_mul(leaky_relu(zp), vmask), head_w(idx),
                                   1, dt)
                pre = h_ab if pre is None else pre + h_ab
        if v3:
            pre = pre + embed_head_channels(wh[:, :, idxs[0], :], bh)[1].to(dt)
            flat = output_stage_x8(pre, self.clamp_min, self.clamp_max)
        else:
            flat = output_stage(pre + bh.to(dt), rt, self.clamp_min,
                                self.clamp_max)
        return flat.reshape(flat.shape[0], flat.shape[1], -1, self.out_nc)

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
        perm = device_constant(_phase_channels, (fs,), torch.int64,
                               wh.device).reshape(-1)
        w64, b64 = embed_head_channels(wh[:, :, perm, :], bh)
        pre64 = head_dot(g4.permute(1, 2, 0, 3), w64.to(dt), b64, nw,
                         b30.repeat(4).to(dt))                 # [H, B, W, 64]
        flat = output_stage_x8(pre64, self.clamp_min, self.clamp_max,
                               order="hbwc")
        return flat.reshape(flat.shape[0], flat.shape[1], -1, self.out_nc)
