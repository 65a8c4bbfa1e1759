"""DepthNet — the flagship generator's forward in the port, for serving and
training.

Counterpart of ``endosr/nn/depthnet.py``, at every scale (×2, ×3, ×4, ×8):

  Encoder (5 weight-norm convs) → region-wise masked pooling into the
  [B,K,L] style matrix → two head convs → the trunk's residual blocks with
  their SEAN modulations → global skip → the scale's tail → 9×9 head →
  clamp → fp32.

With the default fields the trunk's modulations come from the lazy hoisted
branches, one group of ``style_chunk`` blocks at a time. Unmasked, a style
group is one ``style_blend_dot`` and the ×8 tail is the phase-packed one:
up1 chain (``packed_g123``) → tail chain (``packed_g123`` with
``phases``/``pre_act``/``pre_bias``) → folded head (``head_dot``) →
``output_stage_x8``. With ``valid_hw`` (exact bucketed eval: inputs
zero-padded to a bucket shape, every stream re-zeroed outside the valid
region before each conv, InstanceNorm statistics over the valid region,
styles pooled with ``pool_mask``) a style group is one ``style_dot_hwbm``,
the ×8 tail runs as dense folds, and every scale ends in ``output_stage``.
×2/×3/×4 run the folded tail (``_folded_head``, at ×4 phase-split and ending
in ``output_stage_x8`` when unmasked). ``fused_epilogue`` normalizes and
modulates in the ``fused_in_mod`` kernel and ``in_stats="kernel"`` takes the
block InstanceNorm's sums from the ``in_stats`` kernel.

The JAX module's other graph fields (see :class:`DepthNet`) select the
hoisted trunk (``fused_o_branch``, ``fused_modulation``), the fused ×8 head
(``fused_tail``), the dense and the unfolded tails, and turn single kernels
off; ``preset: plain`` turns them all off and launches no kernel. Its
lowering switches are accepted at every value: ``chain_in``,
``lazy_o_chunk``, ``pallas_packed_chain``, ``blend_fold`` and
``obranch_body`` each compute what JAX computes at that value in JAX's op
order; ``tail_defer_act`` and ``mask_stack_conv`` choose between two
lowerings that give the same values in the port, which runs one.

Activations are NHWC; depth masks [B,H,W,K]; the style matrix [B,K,L].
Parameter names follow the reference PyTorch checkpoint
(``depth-residual3.norm1.mlp_mask.0.weight``, ``head.0.weight_v``, ...), and
every configuration shares the one parameter tree. The stream runs in fp32
or bf16; ``modulation_dtype`` and ``centered_convs`` give the precisions
``mixed``, ``bf16c`` and ``bf16c3`` of an fp32 net.

``remat_blocks`` (the ×2 and ×4 training YAMLs) hoists no SEAN branch:
every depth block computes its own two at the stream's dtype, and under
autograd each depth block runs in ``torch.utils.checkpoint``, so the
backward recomputes its insides instead of keeping them. The paper's
ablations (``ablate_depth_matrix``, ``ablate_depth_block``; see
``nn/sean.py``) and the baseline without depth blocks (the encoder's first
conv only, no style matrix) are the JAX module's too.

Inside a ``parallel/spatial.py::spatial`` block the forward, masked or
not, runs on one slab of rows a rank: the layers exchange their halo rows
and statistics (``nn/layers.py``), the region-wise pooling sums over the
ranks (a mask of another size is gathered, resized whole and cut), the
encoder's masks count rows from the slab's first global row, and the
transposed ``layer4`` cuts the last slab to the image's 2n − 1 rows.
The ×8 packed tail (both chains, stage 4, the head and the output stage,
whichever kernels the fields pick) runs on the ``upscale1_0`` output's
slab extended by four LR rows of each neighbour, and the ×4 phase-split
head on its input's slab extended by two rows; each crops its SR rows to
this rank's (``SpatialContext.rows_local``). The packed grid's extra
(dead) LR + 1st row belongs to the last rank.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from endosr_torch.kernels.fused_tail import fused_tail
from endosr_torch.kernels.head_dot import head_dot
from endosr_torch.kernels.output_stage import (embed_head_channels,
                                               output_stage, output_stage_x8)
from endosr_torch.kernels.packed_chain import (packed_g123,
                                               packed_g123_plain,
                                               unfold_g4_phases)
from endosr_torch.nn.layers import (
    Conv,
    WNConv,
    WNConvTranspose,
    centered_conv,
    chained_instance_norm,
    clip,
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
    branch_weights,
    hoisted_blended_mods,
    hoisted_o_branch,
    hoisted_style_branch,
    o_branch_from_actv,
    o_branch_raw_hwnc,
    pallas_o_branch,
    precompute_o_actv,
    precompute_style_v,
    shifted_mask_stack,
    style_blend_chunk,
    style_chunk_dot,
)
from endosr_torch.ops.resize import interpolate_bilinear, interpolate_nearest
from endosr_torch.parallel.spatial import active as spatial_active
from endosr_torch.parallel.spatial import suspended
from endosr_torch.utils.device import device_constant
from endosr_torch.utils.prof import annotate

__all__ = ["DepthNet", "Encoder", "EncoderNoDepthMatrix",
           "region_wise_avg_pooling", "DepthResidualBlock",
           "ClassicResidualBlock"]


def _fold_wb(w, b, r):
    """Fold an fp32 (HWIO kernel, bias) through a pending pixel_shuffle(r)."""
    if r == 1:
        return w, b
    with annotate("net.prepare"):
        return (fold_kernel_through_pixel_shuffle(w, r),
                b.repeat_interleave(r * r))


def _packed_wb(w, b, s_in, s_out, in_interleaved=False):
    """A 3×3 SAME conv's fp32 (HWIO kernel, bias) phase-packed for the ×8
    packed tail (:func:`~endosr_torch.nn.layers.packed_stage_kernel`, the
    bias once per phase group; None for a bias of None)."""
    with annotate("net.prepare"):
        return (packed_stage_kernel(w, s_in, s_out, in_interleaved),
                None if b is None else b.repeat(4))


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
    return _conv_b_pad(x, w, b, w.shape[0] // 2, dtype)


def _conv_b_pad(x, w, b, pad, dtype):
    """Conv of NHWC ``x`` with padding ``pad`` and bias, in ``dtype``."""
    return conv2d_nhwc(x, w, pad, dtype) + b.to(dtype)


def _on(flag) -> bool:
    """A kernel switch of the JAX module: a bool forces, "auto" means on."""
    return flag if isinstance(flag, bool) else True


def _edge_gate(hp: int, wc: int) -> np.ndarray:
    """[1, hp, wc, 1] 0/1 gate of an unshifted packed tensor: its last row
    and last column are the dead slots."""
    g = np.ones((1, hp, wc, 1), np.float32)
    g[:, hp - 1] = 0.0
    g[:, :, wc - 1] = 0.0
    return g


def _slab_rows(x, halo: int, fn, scale: int):
    """``fn(x)``; in a spatial block ``fn`` on this rank's slab extended by
    ``halo`` rows of each neighbour, its output (``scale`` rows an input
    row) cropped to this rank's rows (``SpatialContext.rows_local``)."""
    sp = spatial_active()
    if sp is None:
        return fn(x)
    return sp.rows_local((x,), halo, fn, scale)


def _jax_blend_fits(shape, m: int, n_conv: int, itemsize: int) -> bool:
    """Whether the JAX module runs a style group of ``n_conv`` SEANs (M =
    ``m`` map channels) on a [B,H,W,J] mask stack through its blend kernel
    (``endosr/kernels/style_dot.py::style_blend_supported``, a model of the
    TPU kernel's VMEM: 4-row blocks, W a multiple of 8, at most 8 images and
    an even count in bf16, a 95 MiB budget with 512-channel slices)."""
    b, h, w, j = shape
    c2 = m // n_conv
    mc = next((c for c in (512, 256, 128) if m % c == 0), None)
    if mc is None or mc % c2:
        return False
    vmem = (2 * b * 4 * w * j * itemsize + 2 * b * j * m * itemsize
            + 2 * n_conv * 4 * w * b * c2 * itemsize
            + 2 * 4 * w * b * m * itemsize + 2 * b * 4 * w * mc * 4 * 2)
    return (h % 4 == 0 and w % 8 == 0 and b <= 8
            and (itemsize != 2 or b % 2 == 0) and vmem <= 95 * 1024 * 1024)


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
    at 0.5 first. In a spatial block (``parallel/spatial.py``) both are
    this rank's row slabs and the sums are the whole image's; the resize,
    which mixes rows across slabs, runs on the whole mask (gathered; it is
    small at LR), and the rank keeps its own rows."""
    fh, fw = feature_map.shape[1], feature_map.shape[2]
    sp = spatial_active()
    if mask.shape[1] != fh or mask.shape[2] != fw:
        if sp is None:
            mask = interpolate_bilinear(mask, (fh, fw), align_corners=True)
        else:
            offsets, _, total = sp.slabs(fh, fw)
            whole = sp.gather_rows(mask)
            with suspended():
                mask = interpolate_bilinear(whole, (total, fw),
                                            align_corners=True)
            first = offsets[sp.rank]
            mask = mask[:, first:first + fh]
        mask = (mask >= 0.5).to(feature_map.dtype)
    mask = mask.to(feature_map.dtype)
    sum_feat = torch.einsum("bhwk,bhwl->bkl", mask, feature_map)
    sum_mask = mask.sum(dim=(1, 2))
    if sp is not None:
        sum_feat, sum_mask = sp.sum(sum_feat, sum_mask)
    return sum_feat / (sum_mask[..., None] + 1e-10)


class Encoder(nn.Module):
    """Depth-matrix encoder: (stride-1 32-ch trunk feature, [B,K,L] style
    matrix). ``is_baseline`` (a net without depth blocks): ``layer1`` only,
    and None for the style matrix."""

    def __init__(self, in_nc=3, latent_ch=256, is_baseline=False,
                 device=None):
        super().__init__()
        self.is_baseline = bool(is_baseline)
        self.layer1 = WNConv(in_nc, 32, 3, 1, 1, device=device)
        if self.is_baseline:
            return
        self.layer2 = WNConv(32, 64, 3, 2, 1, device=device)
        self.layer3 = WNConv(64, 128, 3, 2, 1, device=device)
        self.layer4 = WNConvTranspose(128, latent_ch, 3, 2, 1, device=device)
        self.layer5 = WNConv(latent_ch, latent_ch, 3, 2, 1, device=device)

    def forward(self, x, depth_mask, dtype, valid_hw=None, pool_mask=None):
        """``valid_hw`` = (hv, wv): every conv input is re-zeroed outside
        the valid region of its resolution, and the styles are pooled with
        ``pool_mask`` (the host-resized depth mask, zero-padded to the
        latent's shape; see ``ops.masks.pool_mask_np``)."""
        m1 = m2 = m3 = None
        if valid_hw is not None:
            hv, wv = valid_hw
            h, w = x.shape[1], x.shape[2]
            v2h, v2w = (hv + 1) // 2, (wv + 1) // 2      # after stride 2
            v3h, v3w = (v2h + 1) // 2, (v2w + 1) // 2    # after stride 2
            vm = functools.partial(valid_mask, device=x.device)
            m1 = vm((h, w), hv, wv)
            m2 = vm((h // 2, w // 2), v2h, v2w)
            m3 = vm((h // 4, w // 4), v3h, v3w)
        feat = self.layer1(x, dtype)
        if self.is_baseline:
            return _mul(leaky_relu(feat), m1), None
        out = self.layer2(_mul(leaky_relu(feat), m1), dtype)
        out = self.layer3(_mul(leaky_relu(out), m2), dtype)
        out = self.layer4(_mul(leaky_relu(out), m3), dtype)
        m4 = None
        if valid_hw is not None:
            # the transposed conv gives 2n − 1 rows
            m4 = vm((out.shape[1], out.shape[2]), 2 * v3h - 1, 2 * v3w - 1)
        out = self.layer5(_mul(leaky_relu(out), m4), dtype)
        style = region_wise_avg_pooling(
            out, depth_mask if pool_mask is None else pool_mask)
        return _mul(leaky_relu(feat), m1), style


class EncoderNoDepthMatrix(nn.Module):
    """The depth-matrix ablation's encoder (``endosr/nn/depthnet.py``
    ``EncoderNoDepthMatrix``): (the raw stride-1 32-ch trunk feature, a
    spatial latent [B,H',W',L]); no pooling. ``layer4`` gives 2n − 1, so
    H' = H only for odd H (as in JAX, whose SEAN then adds maps of both
    sizes)."""

    def __init__(self, in_nc=3, latent_ch=256, device=None):
        super().__init__()
        self.layer1 = WNConv(in_nc, 32, 3, 1, 1, device=device)
        self.layer2 = WNConv(32, 64, 3, 1, 1, device=device)
        self.layer3 = WNConv(64, 128, 3, 2, 1, device=device)
        self.layer4 = WNConvTranspose(128, 256, 3, 2, 1, device=device)
        self.layer5 = WNConv(256, latent_ch, 3, 1, 1, device=device)

    def forward(self, x, dtype):
        sp = spatial_active()
        if sp is not None and sp.slabs(x.shape[1], x.shape[2])[2] % 2 == 0:
            # an even H gives the latent H − 1 rows, which the SEANs cannot
            # add to their H-row maps (nor can JAX's, on one device or
            # sharded)
            raise ValueError("the depth-matrix ablation needs an odd frame "
                             "height")
        feat = self.layer1(x, dtype)
        out = self.layer2(leaky_relu(feat), dtype)
        out = self.layer3(leaky_relu(out), dtype)
        out = self.layer4(leaky_relu(out), dtype)
        return feat, self.layer5(leaky_relu(out), dtype)


class DepthResidualBlock(nn.Module):
    """conv + IN → SEAN → ReLU → conv + IN → SEAN → +res → ReLU. The block's
    norm and the SEAN's parameter-free norm chain into one statistics pass,
    except under ``fused_epilogue``, where the block's norm is a plain
    ``instance_norm`` (sums from the ``in_stats`` kernel with
    ``in_stats="kernel"``) and the SEAN normalizes and modulates in the
    ``fused_in_mod`` kernel. With ``chain_in`` off the two norms run apart
    (``instance_norm``, then the SEAN's own). ``centered`` = N > 0: both
    convs are N-pass centered bf16 convs with an fp32 output (bf16c /
    bf16c3 serving)."""

    def __init__(self, nf=64, depth_latent_ch=256, depth_range_num=10,
                 use_trainable_params=True, norm_gamma=0.1, norm_beta=0.1,
                 fused_epilogue=False, in_stats="default", centered=0,
                 ablate_depth_matrix=False, ablate_depth_block=False,
                 chain_in=True, device=None):
        super().__init__()
        self.fused_epilogue, self.in_stats = bool(fused_epilogue), in_stats
        self.chain_in = bool(chain_in)
        kw = dict(label_nc=depth_range_num, norm_nc=nf,
                  len_latent=depth_latent_ch,
                  use_trainable_params=use_trainable_params,
                  norm_gamma=norm_gamma, norm_beta=norm_beta,
                  ablate_depth_matrix=ablate_depth_matrix,
                  ablate_depth_block=ablate_depth_block, device=device)
        conv = functools.partial(Conv, nf, nf, 3, centered=centered,
                                 device=device)
        self.conv1 = nn.ModuleDict({"0": conv()})
        self.norm1 = SEAN(**kw)
        self.conv2 = nn.ModuleDict({"0": conv()})
        self.norm2 = SEAN(**kw)

    def init_(self, gen):
        for m in (self.conv1["0"], self.norm1, self.conv2["0"], self.norm2):
            m.init_(gen)

    def forward(self, x, dtype, depth, ob=None, sb=None, mod=None, vmask=None):
        """``depth`` = (depth_map, depth_mask, style matrix); ``ob``/``sb``/
        ``mod``: per-SEAN pairs of precomputed modulations (see
        :meth:`SEAN.forward`); ``vmask``: valid-region mask of exact
        bucketed eval."""
        chain = self.chain_in and not self.fused_epilogue
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
    calling it. ``centered`` as for :class:`DepthResidualBlock`."""

    def __init__(self, nf=64, centered=0, device=None):
        super().__init__()
        conv = functools.partial(WNConv, nf, nf, 3, centered=centered,
                                 device=device)
        self.block = nn.ModuleDict({"0": conv(), "2": conv()})

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
    """The DepthNet forward. The fields below the model's own are
    the JAX module's graph switches with its defaults (lazy branches,
    blend-fused or masked style groups, folded tails, the packed ×8 tail
    when unmasked, kernel output stages):

    ``lazy_branches`` off, ``pallas_obranch`` or ``fused_modulation`` take
    the trunk's SEAN branches off the lazy path onto the hoisted one: the
    modulation maps of a whole group of ``hoist_chunk`` blocks (0: all) are
    made before its first block, by ``hoisted_o_branch`` (or, unmasked,
    the ``fused_o_branch`` kernel) and, with ``hoist_style``,
    ``hoisted_style_branch``, or both at once by the ``fused_modulation``
    kernel. ``pallas_style`` / ``pallas_style_blend`` off replace the lazy
    path's two style kernels by plain matmuls and per-block blends.
    ``packed_tail`` / ``packed_up1`` off run the ×8 tail's halves as dense
    PS(2) folds; ``pallas_tail`` ends the packed tail in ``fused_tail``
    instead of ``head_dot`` + ``output_stage_x8``; ``pallas_head`` /
    ``pallas_output`` off replace those two by plain convs and shuffles.
    ``fold_tail`` / ``fold_output_conv`` off run the tail with real
    PixelShuffles (the only tail for a depth block at nb-1 when scale ≥ 4).

    The precisions beside ``dtype`` (the stream's): ``modulation_dtype``
    computes the trunk's hoisted and lazy SEAN branches in that dtype (bf16
    maps in an fp32 net: ``precision: mixed``), and ``centered_convs`` = N
    runs the residual blocks' convs, and at scale ≥ 4 the tail's, as N-pass
    :func:`~endosr_torch.nn.layers.centered_conv` in bf16 with an fp32
    output (``bf16c`` N = 1, ``bf16c3`` N = 3); below ×4 the tail and its
    classic blocks stay in ``dtype``, and at ×8 the tail takes its dense
    folds.

    ``remat_blocks``, ``ablate_depth_matrix``, ``ablate_depth_block`` and
    an empty ``which_resblk_depth`` (the baseline) are the JAX module's
    fields of those names (see the module's docstring); under
    ``remat_blocks`` and ``ablate_depth_block`` no branch is hoisted, and
    every SEAN computes its own at ``dtype``.

    The JAX module's lowering switches: ``chain_in`` off runs a block's
    InstanceNorm and its SEAN's apart; ``lazy_o_chunk`` = G > 0 makes the
    lazy o-branch's shared first conv per group of G trunk blocks, right
    before the group (a style group then takes ``style_blend_dot`` only
    when one o-group covers it, as in JAX); ``pallas_packed_chain`` off
    runs both ×8 packed chains as plain convs and gates (no
    ``packed_g123``); ``blend_fold`` folds the α blend into the lazy
    branches where the blend kernel does not run; ``obranch_body: dot``
    runs the o-branch's first conv as a 9-tap product. ``tail_defer_act``
    and ``mask_stack_conv`` have no effect: in JAX, off applies the up1
    chain's stage-4 bias and leaky_relu before the tail chain instead of
    in its load, and builds the shifted mask stack by pad and slice
    instead of a 0/1 conv; both give the values of their default here (the
    chain's load rounds as the separate ops do, and a 0/1 conv copies),
    so the port runs the default."""

    def __init__(self, which_resblk_depth=tuple(range(14)), in_nc=3, out_nc=3,
                 nf=64, nb=16, scale=4, clamp_min=0.0, clamp_max=1.0,
                 depth_latent_ch=256, depth_range_num=10,
                 use_trainable_params=True, norm_gamma=0.1, norm_beta=0.1,
                 fused_epilogue=False, in_stats="default", style_chunk=7,
                 lazy_branches=True, hoist_style=True, hoist_chunk=0,
                 pallas_obranch=False, fused_modulation=False,
                 pallas_style="auto", pallas_style_blend="auto",
                 packed_tail=True, packed_up1=True, pallas_tail=False,
                 pallas_head="auto", pallas_output="auto", fold_tail=True,
                 fold_output_conv=True, modulation_dtype=None,
                 centered_convs=0, remat_blocks=False,
                 ablate_depth_matrix=False, ablate_depth_block=False,
                 chain_in=True, lazy_o_chunk=0, pallas_packed_chain="auto",
                 blend_fold=False, obranch_body="conv", tail_defer_act=True,
                 mask_stack_conv=True, dtype=torch.float32, device=None):
        super().__init__()
        which = set(which_resblk_depth)
        if obranch_body not in ("conv", "dot"):
            raise ValueError(f"obranch_body must be 'conv' or 'dot', got "
                             f"{obranch_body!r}")
        if scale not in (2, 3, 4, 8):
            raise NotImplementedError(f"scale {scale} is not ported")
        for dt in (dtype, modulation_dtype or dtype):
            if dt not in (torch.float32, torch.bfloat16):
                raise NotImplementedError(f"precision {dt} is not ported")
        if in_stats not in ("default", "kernel"):
            raise ValueError(f"in_stats must be 'default' or 'kernel', got "
                             f"{in_stats!r}")
        self.which, self.scale = which, scale
        self.nb, self.out_nc = nb, out_nc
        self.clamp_min, self.clamp_max = clamp_min, clamp_max
        self.fused_epilogue = bool(fused_epilogue)
        self.style_chunk = max(1, int(style_chunk))
        self.lazy_branches = bool(lazy_branches)
        self.hoist_style, self.hoist_chunk = bool(hoist_style), int(hoist_chunk)
        self.pallas_obranch = bool(pallas_obranch)
        self.fused_modulation = bool(fused_modulation)
        self.pallas_style = _on(pallas_style)
        self.pallas_style_blend = _on(pallas_style_blend)
        self.packed_tail, self.packed_up1 = bool(packed_tail), bool(packed_up1)
        self.pallas_tail, self.pallas_head = _on(pallas_tail), _on(pallas_head)
        self.pallas_output = _on(pallas_output)
        self.fold_tail = bool(fold_tail)
        self.fold_output_conv = bool(fold_output_conv)
        self.remat_blocks = bool(remat_blocks)
        self.ablate_depth_matrix = bool(ablate_depth_matrix)
        self.ablate_depth_block = bool(ablate_depth_block)
        self.chain_in = bool(chain_in)
        self.lazy_o_chunk = int(lazy_o_chunk)
        self.pallas_packed_chain = _on(pallas_packed_chain)
        self.blend_fold = bool(blend_fold)
        self.obranch_body = obranch_body
        del tail_defer_act, mask_stack_conv   # no effect (see above)
        self.dtype = dtype
        self.mod_dtype = modulation_dtype or dtype
        self.centered_convs = cc = int(centered_convs)
        # the tail's convs are centered at scale ≥ 4 only
        self.tail_cc = cc if scale >= 4 else 0
        # ×8: the trailing 2 blocks at 32 ch; ×4: 1; ×2/×3: all at nf
        num_last_block = 1 if scale == 3 else int(math.log2(scale))
        self.final_scale = fs = 3 if scale == 3 else 2

        if self.ablate_depth_matrix:
            self.encoder = EncoderNoDepthMatrix(in_nc, depth_latent_ch,
                                                device=device)
        else:
            self.encoder = Encoder(in_nc, depth_latent_ch,
                                   is_baseline=not which, device=device)
        self.head = nn.ModuleDict({"0": WNConv(32, 64, 3, device=device),
                                   "2": WNConv(64, 64, 3, device=device)})
        self.block_names = {}
        for i in [*range(nb - 3), nb - 2, nb - 1]:
            ch = 32 if i > nb - num_last_block else nf
            if i in which:
                name = f"depth-residual{i + 1}"
                blk = DepthResidualBlock(
                    ch, depth_latent_ch, depth_range_num, use_trainable_params,
                    norm_gamma, norm_beta, self.fused_epilogue, in_stats, cc,
                    self.ablate_depth_matrix, self.ablate_depth_block,
                    self.chain_in, device=device)
            else:
                name = f"classic-residual{i + 1}"
                tail_blk = i >= nb - 2 and scale < 4
                blk = ClassicResidualBlock(ch, 0 if tail_blk else cc,
                                           device=device)
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

    def forward(self, x, depth_map, depth_mask, valid_hw=None, pool_mask=None):
        """x [B,H,W,3], depth_map [B,H,W,1], depth_mask [B,H,W,K] →
        [B,s·H,s·W,3] fp32 in [clamp_min, clamp_max].

        Differentiable: every weight is prepared (weight norm, folds,
        packed kernels) from the parameters inside the forward, and the
        kernels run through their gradient ``Function`` when an input
        requires a gradient. Serving calls it under ``torch.inference_mode``
        (``models/f_depthcond.py``).

        ``valid_hw`` = (hv, wv), plain ints: exact bucketed eval of inputs
        zero-padded to H, W (multiples of 4) with ``pool_mask`` from
        ``ops.masks.pool_mask_np``; the [:hv·s, :wv·s] crop of the output
        equals the forward of the unpadded input up to fp32 summation
        order."""
        dt, mdt, nb = self.dtype, self.mod_dtype, self.nb
        ablated = self.ablate_depth_matrix or self.ablate_depth_block
        if valid_hw is not None and (ablated or self.fused_epilogue):
            raise ValueError("exact bucketed eval (valid_hw) supports the "
                             "standard DepthNet paths only, not the ablations "
                             "or the fused epilogue")
        vr = _ValidRegion(x, valid_hw)
        with annotate("net.encoder"):
            if self.ablate_depth_matrix:
                feat, depth_vec = self.encoder(x, dt)
            else:
                feat, depth_vec = self.encoder(x, depth_mask, dt, valid_hw,
                                               pool_mask)
            fea = vr.zero(leaky_relu(self.head["0"](feat, dt)))
            fea_bef = vr.zero(leaky_relu(self.head["2"](fea, dt)))
        fea_in = fea_bef
        depth = (depth_map, depth_mask, depth_vec)

        trunk_depth = [i for i in range(nb - 3) if i in self.which]
        # remat_blocks and the depth-block ablation hoist no branch
        hoist = bool(trunk_depth and not self.remat_blocks
                     and not self.ablate_depth_block)
        # the fused modulation cannot re-zero its activation: unmasked only;
        # the depth-matrix ablation hoists its o-branch only
        can_fuse = (self.fused_modulation and not vr.on
                    and not self.ablate_depth_matrix)
        want_style = ((self.hoist_style and not self.ablate_depth_matrix)
                      or can_fuse)
        lazy = bool(hoist and self.lazy_branches and not can_fuse
                    and not self.pallas_obranch)
        style_groups, hoist_groups, slot = {}, {}, {}
        o_groups, actv = {}, {}

        def by(g):
            return {grp[0]: grp for grp in (
                trunk_depth[j:j + g] for j in range(0, len(trunk_depth), g))}

        with annotate("net.branches"):
            if hoist:
                size = (feat.shape[1], feat.shape[2])
                dmap = interpolate_nearest(depth_map, size)
                dmask = (interpolate_nearest(depth_mask, size) if want_style
                         else None)
            if lazy:
                norms = [n for i in trunk_depth
                         for n in (self.block(i).norm1, self.block(i).norm2)]
                o_w, s_w = branch_weights(norms, want_style)
                slot = {i: k for k, i in enumerate(trunk_depth)}
                if self.lazy_o_chunk > 0:
                    o_groups = by(self.lazy_o_chunk)
                else:
                    actv = dict(enumerate(precompute_o_actv(
                        o_w, dmap, mdt, vr.mask_for(dmap), self.obranch_body)))
                if want_style:
                    shifted = shifted_mask_stack(dmask, mdt)
                    v_chunks = precompute_style_v(s_w, depth_vec, mdt)
                    style_groups = by(self.style_chunk)
            elif hoist:
                hoist_groups = by(self.hoist_chunk if self.hoist_chunk > 0
                                  else len(trunk_depth))
        mods = {}
        blend = self.blend_fold and want_style

        with annotate("net.trunk"):
            for i in range(nb - 3):
                if i in o_groups or i in hoist_groups or i in style_groups:
                    with annotate("net.branches"):
                        if i in o_groups:
                            # the group's slice of the shared first conv (its
                            # output channels), made right before its blocks
                            ks = [2 * slot[j] + half for j in o_groups[i]
                                  for half in (0, 1)]
                            actv.update(zip(ks, precompute_o_actv(
                                [o_w[k] for k in ks], dmap, mdt,
                                vr.mask_for(dmap), self.obranch_body)))
                        if i in hoist_groups:
                            mods.update(self._hoist_group(
                                hoist_groups[i], dmap, dmask, depth_vec, vr,
                                can_fuse, want_style))
                        if i in style_groups:
                            mods.update(self._group_mods(
                                style_groups[i], slot, actv, o_w, s_w,
                                v_chunks, shifted, vr.on, blend))
                kw = mods.pop(i, {})
                if i in slot and "mod" not in kw:
                    # lazy without the blend kernel: conv2 runs per block
                    ks = [2 * slot[i] + half for half in (0, 1)]
                    if blend:
                        # blend fold: (1−α)-scaled conv2 + the α-scaled
                        # style half with the blended bias
                        obs = [o_branch_from_actv(actv.pop(k), o_w[k], mdt, al)
                               for k, al in zip(ks, self._alphas(i))]
                        kw["mod"] = tuple((o[0] + sb[0], o[1] + sb[1])
                                          for o, sb in zip(obs, kw.pop("sb")))
                    else:
                        kw["ob"] = tuple(o_branch_from_actv(
                            actv.pop(k), o_w[k], mdt) for k in ks)
                fea_in = self._run_block(i, fea_in, depth, vr, **kw)
            feat_add1 = fea_in + fea_bef                     # global skip

        with annotate("net.tail"):
            if (self.scale == 8 and self.fold_tail and self.fold_output_conv
                    and (nb - 2) not in self.which
                    and (nb - 1) not in self.which):
                packed = self.packed_tail and not vr.on and not self.tail_cc
                if packed and self.packed_up1:
                    # the whole packed tail reaches 4 LR rows: h_pre[Y−2..Y+2]
                    # make up1's g4 row Y, and a head row reads 3 fine rows
                    return _slab_rows(
                        self.upscale1["0"](feat_add1, self.dtype), 4,
                        self._packed_from_h_pre, 8)
                z = self._dense_fold1(feat_add1, vr)
                if packed:
                    return _slab_rows(z, 3, self._packed_tail, 4)
                return self._dense_fold2_tail(z, vr)
            return self._tail(feat_add1, depth, vr)

    def _alphas(self, i):
        """Block ``i``'s two SEANs' (α_γ, α_β)."""
        blk = self.block(i)
        return blk.norm1.blend_alphas(), blk.norm2.blend_alphas()

    def _run_block(self, i, feat, depth, vr, **kw):
        """Block ``i`` on ``feat``; under ``remat_blocks`` and autograd a
        depth block runs in ``torch.utils.checkpoint`` (JAX: ``nn.remat``)."""
        blk = self.block(i)
        vmask = vr.mask_for(feat)
        if not isinstance(blk, DepthResidualBlock):
            return blk(feat, self.dtype, vmask=vmask)
        if self.remat_blocks and torch.is_grad_enabled():
            return checkpoint(
                lambda f: blk(f, self.dtype, depth, vmask=vmask, **kw), feat,
                use_reentrant=False)
        return blk(feat, self.dtype, depth, vmask=vmask, **kw)

    def _hoist_group(self, ids, dmap, dmask, depth_vec, vr, can_fuse,
                     want_style):
        """The hoisted (non-lazy) trunk: the modulation maps of both SEANs
        of every block in ``ids``, made whole before the group's first
        block. One ``fused_modulation`` launch gives the finished (γ, β)
        ({"mod": ...}); otherwise the o-branch comes from ``fused_o_branch``
        (``pallas_obranch``, unmasked) or ``hoisted_o_branch`` ({"ob": ...})
        and, with ``want_style``, the style branch from
        ``hoisted_style_branch`` ({"sb": ...}); a SEAN computes a missing
        branch itself and blends. In ``modulation_dtype``."""
        dt = self.mod_dtype
        norms = [n for i in ids
                 for n in (self.block(i).norm1, self.block(i).norm2)]
        o_w, s_w = branch_weights(norms, want_style)

        def per_block(pairs):
            return [(pairs[2 * k], pairs[2 * k + 1]) for k in range(len(ids))]

        if can_fuse:
            mods = hoisted_blended_mods(o_w, s_w,
                                        [n.blend_alphas() for n in norms],
                                        dmap, dmask, depth_vec, dt)
            return {i: {"mod": m} for i, m in zip(ids, per_block(mods))}
        if self.pallas_obranch and not vr.on:
            obs = pallas_o_branch(o_w, dmap, dt)
        else:
            obs = hoisted_o_branch(o_w, dmap, dt, vmask=vr.mask_for(dmap),
                                   body=self.obranch_body)
        out = {i: {"ob": ob} for i, ob in zip(ids, per_block(obs))}
        if want_style:
            sbs = hoisted_style_branch(s_w, dmask, depth_vec, dt)
            for i, sb in zip(ids, per_block(sbs)):
                out[i]["sb"] = sb
        return out

    def _blends(self, shifted, ks, v_chunks):
        """Whether an unmasked style group takes ``style_blend_dot``. In a
        net of one dtype always (both routes round alike). With bf16 maps
        in an fp32 net only where the JAX module blends
        (:func:`_jax_blend_fits`): there the route sets the rounding, since
        the blend rounds the finished (γ, β) to bf16 and the SEAN's 1 + γ
        then rounds in bf16, while the other route blends the two bf16
        halves in fp32."""
        if self.mod_dtype == self.dtype:
            return True
        return _jax_blend_fits(tuple(shifted.shape),
                               sum(v_chunks[k].shape[-1] for k in ks),
                               len(ks), shifted.element_size())

    def _group_mods(self, ids, slot, actv, o_w, s_w, v_chunks, shifted,
                    masked, blend=False):
        """The lazy trunk: modulations of both SEANs of every block in
        ``ids`` from one launch: unmasked, the finished (γ, β) through
        ``style_blend_dot`` ({"mod": ...}); masked, with
        ``pallas_style_blend`` off, where :meth:`_blends` says no or where
        the o-branch prefix of some block of the group is not made yet
        (``lazy_o_chunk``), the style halves ({"sb": ...}) through
        ``style_dot_hwbm`` (a plain matmul with ``pallas_style`` off), in
        the blend-fold form with ``blend``. In ``modulation_dtype``."""
        dt = self.mod_dtype
        ks = [2 * slot[i] + half for i in ids for half in (0, 1)]
        alphas = [a for i in ids for a in self._alphas(i)]
        if (masked or not self.pallas_style_blend
                or not all(k in actv for k in ks)
                or not self._blends(shifted, ks, v_chunks)):
            outs = style_chunk_dot(
                shifted, [v_chunks[k] for k in ks], [s_w[k] for k in ks], dt,
                self.pallas_style, alphas=alphas if blend else None,
                o_biases=[o_w[k][3] for k in ks] if blend else None)
            return {i: {"sb": (outs[2 * n], outs[2 * n + 1])}
                    for n, i in enumerate(ids)}
        convs = [o_branch_raw_hwnc(actv.pop(k), o_w[k], dt, al)
                 for k, al in zip(ks, alphas)]
        outs = style_blend_chunk(shifted, [v_chunks[k] for k in ks],
                                 [s_w[k] for k in ks], alphas,
                                 [o_w[k][3] for k in ks], convs, dt)
        return {i: {"mod": (outs[2 * n], outs[2 * n + 1])}
                for n, i in enumerate(ids)}

    def _tconv(self, x, w, b, passes=None):
        """A SAME tail conv with an fp32 (HWIO kernel, bias): centered in
        ``passes`` passes (default: ``centered_convs`` at scale ≥ 4) or in
        the stream's dtype."""
        passes = self.tail_cc if passes is None else passes
        if passes:
            return centered_conv(x, w, b, torch.bfloat16, passes)
        return _conv_b(x, w, b, self.dtype)

    def _emit(self, pre, r):
        """clamp → PixelShuffle(r) → fp32 [B, H·r, W·r, out_nc]: the
        ``output_stage`` kernel, or plain ops with ``pallas_output`` off."""
        if self.pallas_output:
            flat = output_stage(pre, r, self.clamp_min, self.clamp_max)
            return flat.reshape(flat.shape[0], flat.shape[1], -1, self.out_nc)
        return pixel_shuffle(clip(pre, self.clamp_min, self.clamp_max),
                             r).float()

    def _head_wb(self, r, perm=None):
        """The 9×9 head's fp32 (HWIO kernel, bias) folded through PS(r)
        (r ≥ 2), its input channels in ``perm``'s order when given."""
        with annotate("net.prepare"):
            w = fold_kernel_through_pixel_shuffle(
                hwio(self.conv_output.weight).float(), r)
            b = self.conv_output.bias.float().repeat_interleave(r * r)
            return (w if perm is None else w[:, :, perm, :]), b

    def _folded_classic(self, blk, z, r, vr):
        """A classic block on a PS(r)-pending tensor: both convs folded."""
        (w0, b0), (w2, b2) = blk.effective_weights()
        t = torch.relu(self._tconv(vr.zero(z), *_fold_wb(w0, b0, r)))
        return torch.relu(z + self._tconv(vr.zero(t), *_fold_wb(w2, b2, r)))

    def _dense_fold1(self, feat_add1, vr):
        """The first half of the dense ×8 tail (the masked forward, or
        ``packed_up1`` / ``packed_tail`` off): upscale1_3, block nb-2 and
        upscale2_0 as dense PS(2) folds at LR², then the one real
        PixelShuffle(2)."""
        wn = wn_effective_kernel
        h = leaky_relu(self.upscale1["0"](feat_add1, self.dtype))
        z = leaky_relu(self._tconv(vr.zero(h),
                                   *_fold_wb(*wn(self.upscale1["3"]), 2)))
        z = self._folded_classic(self.block(self.nb - 2), z, 2, vr)
        z = leaky_relu(self._tconv(vr.zero(z),
                                   *_fold_wb(*wn(self.upscale2["0"]), 2)))
        return pixel_shuffle(z, 2)

    def _dense_fold2_tail(self, z, vr):
        """The second half of the dense ×8 tail: upscale2_3 and block nb-1
        folded by 2, and the folded head."""
        w23, b23 = _fold_wb(*wn_effective_kernel(self.upscale2["3"]), 2)
        z = leaky_relu(self._tconv(vr.zero(z), w23, b23))
        z = self._folded_classic(self.block(self.nb - 1), z, 2, vr)
        return self._folded_head(z, 2, vr)

    def _tail(self, feat_add1, depth, vr):
        """The tail of ×2/×3/×4, and of ×8 with a depth block at nb-2 or
        nb-1 or with ``fold_tail`` / ``fold_output_conv`` off: upscale1 at
        real resolution (×8 only), block nb-2, then, folded, every later
        PixelShuffle deferred into folded kernels; unfolded (the switches
        off, or a depth block at nb-1 for scale ≥ 4, whose InstanceNorm
        does not commute with a pending shuffle), real shuffles and the
        plain upscale3 and 9×9 head."""
        dt, nb, fs = self.dtype, self.nb, self.final_scale
        z = feat_add1
        if self.scale == 8:
            h = pixel_shuffle(leaky_relu(self.upscale1["0"](z, dt)), 2)
            z = vr.zero(leaky_relu(self.upscale1["3"](vr.zero(h), dt)))
        z = self._run_block(nb - 2, z, depth, vr)
        fold = (self.fold_tail and self.fold_output_conv
                and (self.scale < 4 or (nb - 1) not in self.which))
        r = 1
        if self.scale >= 4:
            # the conv's output channels are already in canonical PS(2) order
            z = leaky_relu(self._tconv(z, *wn_effective_kernel(
                self.upscale2["0"])))
            if fold:
                r = 2
            else:
                z = pixel_shuffle(z, 2)
            w23, b23 = _fold_wb(*wn_effective_kernel(self.upscale2["3"]), r)
            z = leaky_relu(self._tconv(vr.zero(z), w23, b23))
            if fold:
                z = self._folded_classic(self.block(nb - 1), z, r, vr)
            else:
                z = self._run_block(nb - 1, vr.zero(z), depth, vr)
        else:
            z = self._run_block(nb - 1, z, depth, vr)
        if fold:
            return self._folded_head(z, r, vr)
        h = self._tconv(z, *wn_effective_kernel(self.upscale3["0"]))
        if self.fold_output_conv:
            # only the head is folded through the final shuffle
            wh, bh = self._head_wb(fs)
            out = pixel_shuffle(self._tconv(vr.zero(leaky_relu(h)), wh, bh), fs)
        else:
            out = self.conv_output(vr.zero(leaky_relu(pixel_shuffle(h, fs))), dt)
        return clip(out.float(), self.clamp_min, self.clamp_max)

    def _folded_head(self, z, r, vr):
        """upscale3 + the 9×9 head with every pending shuffle deferred: ``z``
        holds PS(r)-pending features in canonical order; upscale3_0 and the
        head are folded through the pending shuffles and one output stage
        emits the clamped fp32 image. With r = 2 the folded upscale3_0 runs
        phase-split (:meth:`_phase_split_head`), unless the tail's convs are
        centered."""
        fs = self.final_scale
        vmask = vr.mask_for(z)
        w30, b30 = _fold_wb(*wn_effective_kernel(self.upscale3["0"]), r)
        # defer upscale3's shuffle too: canonical PS(r·fs) channel order
        perm = device_constant(compose_pixel_shuffle_perm,
                               (r, fs, 32 * fs * fs * r * r), torch.int64,
                               w30.device)
        with annotate("net.prepare"):
            w30, b30 = w30[..., perm], b30[perm]
        if r == 2 and not self.tail_cc:
            return self._phase_split_head(_mul(z, vmask), w30, b30, vmask)
        # JAX's folded head takes ``bool(centered_convs)`` as its pass count
        # (``endosr/nn/depthnet.py:1553``): one pass under bf16c3 too
        passes = min(self.tail_cc, 1)
        z = self._tconv(_mul(z, vmask), w30, b30, passes)
        rt = r * fs
        wh, bh = self._head_wb(rt)
        return self._emit(
            self._tconv(_mul(leaky_relu(z), vmask), wh, bh, passes), rt)

    def _phase_split_head(self, z, w30, b30, vmask):
        """The r = 2 folded head: a 3×3 conv folded through PS(2) is 75 %
        structural zeros (output phase (a, b) reads taps u ∈ {a, a+1},
        v ∈ {b, b+1} only), so the dense [3,3,C,4M] upscale3_0 runs as four
        [2,2,C,M] phase convs, and the head reads the four phase tensors
        as an input-channel split of its folded conv. Unmasked the four
        are one wide conv on a pad-1 grid with per-phase border gates, and
        the ×4/×8 head (r·fs = 4, 3 colours) ends in ``output_stage_x8``;
        masked they run apart, each re-zeroed outside the valid region.
        Unmasked in a spatial block the wide conv's grid has a row more
        than the image: the head runs on the slab extended by two rows of
        each neighbour and keeps this rank's rows."""
        dt, fs = self.dtype, self.final_scale
        rt = 2 * fs
        if vmask is None and spatial_active() is not None:
            return _slab_rows(z, 2, lambda zz: self._phase_split_head(
                zz, w30, b30, None), rt)
        wh, bh = self._head_wb(rt)
        phases = [(a, b) for a in (0, 1) for b in (0, 1)]
        idxs = list(device_constant(_phase_channels, (fs,), torch.int64,
                                    z.device))
        m_per = 32 * fs * fs
        v3 = (self.pallas_output and vmask is None and rt == 4
              and self.out_nc == 3)
        with annotate("net.prepare"):
            # each phase's upscale3_0 taps and bias, and its head kernel
            w_ph = [w30[a:a + 2, b:b + 2][..., idx]
                    for (a, b), idx in zip(phases, idxs)]
            b_ph = [b30[idx] for idx in idxs]
            heads = [wh[:, :, idx, :] for idx in idxs]
            if v3:
                heads = [embed_head_channels(w_ab, bh)[0] for w_ab in heads]
                b64 = embed_head_channels(wh[:, :, idxs[0], :], bh)[1]
            if vmask is None:
                w_all, b_all = torch.cat(w_ph, dim=-1), torch.cat(b_ph)

        pre = None
        if vmask is None:
            big = leaky_relu(conv2d_nhwc(z, w_all, 1, dt) + b_all.to(dt))
            bsz, hb, wb, _ = big.shape
            gate = device_constant(_phase_gate, (hb - 1, wb - 1), dt, z.device)
            big = (big.reshape(bsz, hb, wb, 4, m_per) * gate).reshape(big.shape)
            for k, ((a, b), w_h) in enumerate(zip(phases, heads)):
                h_ab = conv2d_nhwc(big[..., m_per * k:m_per * (k + 1)],
                                   w_h, ((1 - a, a), (1 - b, b)), dt)
                pre = h_ab if pre is None else pre + h_ab
        else:
            for (a, b), w_p, b_p, w_h in zip(phases, w_ph, b_ph, heads):
                zp = conv2d_nhwc(z, w_p, ((1 - a, a), (1 - b, b)),
                                 dt) + b_p.to(dt)
                h_ab = conv2d_nhwc(_mul(leaky_relu(zp), vmask), w_h, 1, dt)
                pre = h_ab if pre is None else pre + h_ab
        if v3:
            pre = pre + b64.to(dt)
            flat = output_stage_x8(pre, self.clamp_min, self.clamp_max)
            return flat.reshape(flat.shape[0], flat.shape[1], -1, self.out_nc)
        return self._emit(pre + bh.to(dt), rt)

    def _packed_from_h_pre(self, h_pre):
        """The ×8 packed tail from upscale1_0's raw output: the up1 chain,
        then the tail chain on its packed output (:meth:`_packed_tail`)."""
        z_g4, pre_bias = self._packed_up1(h_pre)
        if self.pallas_packed_chain:
            return self._packed_tail(z_g4=z_g4, pre_bias=pre_bias)
        # the plain chain reads the interleaved fine grid, BHWC-contiguous
        # (an HWBC layout would make cuDNN write the tail's g4 with strided
        # channels, which head_dot refuses)
        return self._packed_tail(unfold_g4_phases(
            z_g4.permute(1, 2, 0, 3)).permute(2, 0, 1, 3).contiguous())

    def _packed_up1(self, h_pre):
        """upscale1_3 → block nb-2 → upscale2_0 as the packed up1 chain on the
        (LR+1)² grid, from upscale1_0's raw output ``h_pre``. Returns (the
        packed stage-4 output, its deferred bias or None): with the chain
        kernel stage 4 runs raw, its bias and leaky_relu applied by the
        tail chain's load (pre_bias / pre_act); ``pallas_packed_chain``
        off: the stages as plain convs and gates, stage 4 activated
        here."""
        dt, nb = self.dtype, self.nb
        w13, b13 = wn_effective_kernel(self.upscale1["3"])
        (w50, b50), (w52, b52) = self.block(nb - 2).effective_weights()
        w20, b20 = wn_effective_kernel(self.upscale2["0"])
        chain = packed_g123 if self.pallas_packed_chain else packed_g123_plain
        g3 = chain(
            h_pre.permute(1, 2, 0, 3),
            *_packed_wb(w13, b13, 0, 1, in_interleaved=True),
            *_packed_wb(w50, b50, 1, 0), *_packed_wb(w52, b52, 0, 1),
            pre_act=True).permute(2, 0, 1, 3)
        g4 = conv2d_nhwc(g3, _packed_wb(w20, None, 1, 0)[0], ((0, 1), (0, 1)),
                         dt)
        if self.pallas_packed_chain:
            return g4, b20
        return leaky_relu(g4 + b20.repeat(4).to(dt)), None

    def _packed_tail(self, z=None, z_g4=None, pre_bias=None):
        """upscale2_3, block nb-1 and upscale3_0 on the phase-packed grid,
        from the mid-tail tensor ``z`` [B, 2N, 2N, 128] or, in its place,
        the packed up1 output ``z_g4`` [B, N+1, N+1, 512] (raw with its
        deferred ``pre_bias``, or activated when there is none; the chain
        interleaves it while it loads);
        then the folded 9×9 head and the output stage: ``fused_tail``
        (``pallas_tail``), ``head_dot`` + ``output_stage_x8``
        (``pallas_head``), or a plain conv and :meth:`_emit`."""
        dt = self.dtype
        lo, hi = self.clamp_min, self.clamp_max
        fs, rt = 2, 4
        w23, b23 = wn_effective_kernel(self.upscale2["3"])
        (wc0, bc0), (wc2, bc2) = self.block(self.nb - 1).effective_weights()
        src = z if z_g4 is None else z_g4
        nw = src.shape[2] if z_g4 is None else 2 * (src.shape[2] - 1)
        chain = packed_g123 if self.pallas_packed_chain else packed_g123_plain
        g3 = chain(
            src.to(dt).permute(1, 2, 0, 3),
            *_packed_wb(w23, b23, 0, 1, in_interleaved=True),
            *_packed_wb(wc0, bc0, 1, 0), *_packed_wb(wc2, bc2, 0, 1),
            pre_act=pre_bias is not None,
            pre_bias=None if pre_bias is None else pre_bias.to(dt),
            phases=z_g4 is not None).permute(2, 0, 1, 3)
        w30, b30 = wn_effective_kernel(self.upscale3["0"])
        k30, pb = _packed_wb(w30, b30, 1, 0)
        g4 = conv2d_nhwc(g3, k30, ((0, 1), (0, 1)), dt)
        # head folded by rt, input channels permuted from canonical PS(rt)
        # order to g4's group-major packed order
        perm = device_constant(_phase_channels, (fs,), torch.int64,
                               g3.device).reshape(-1)
        wh, bh = self._head_wb(rt, perm)
        rgb = self.out_nc == 3
        # fused_tail and head_dot take g4 raw: its bias + leaky_relu and the
        # s=0 gate run inside the kernel while it loads
        pb = pb.to(dt)
        if self.pallas_tail and rgb:
            with annotate("net.prepare"):
                wt = wh.to(dt)
            flat = fused_tail(g4.permute(1, 2, 0, 3), wt, bh, lo, hi, "hwbc",
                              nw, pb)
            return flat.reshape(flat.shape[0], flat.shape[1], -1, self.out_nc)
        if self.pallas_head and rgb:
            with annotate("net.prepare"):
                w64, b64 = embed_head_channels(wh, bh)
                w64 = w64.to(dt)
            pre64 = head_dot(g4.permute(1, 2, 0, 3), w64, b64, nw,
                             pb)                                 # [H, B, W, 64]
            flat = output_stage_x8(pre64, lo, hi, order="hbwc")
            return flat.reshape(flat.shape[0], flat.shape[1], -1, self.out_nc)
        # the other heads take g4 activated and gated (dead last row/column)
        gate = device_constant(_edge_gate, (g4.shape[1], g4.shape[2]), dt,
                               g4.device)
        g4 = leaky_relu(g4 + pb) * gate
        if self.pallas_output and rgb:
            with annotate("net.prepare"):
                w64, b64 = embed_head_channels(wh, bh)
            pre64 = conv2d_nhwc(g4, w64, ((1, 0), (1, 0)), dt) + b64.to(dt)
            flat = output_stage_x8(pre64, lo, hi)
            return flat.reshape(flat.shape[0], flat.shape[1], -1, self.out_nc)
        return self._emit(_conv_b_pad(g4, wh, bh, ((1, 0), (1, 0)), dt), rt)
