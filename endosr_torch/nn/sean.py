"""SEAN depth-conditioned normalization — the serving subset of the port.

Counterpart of ``endosr/nn/sean.py``. For the trunk, DepthNet evaluates
every instance's depth-map branch (o) and depth-matrix branch (s) ahead of
the blocks, in one of two forms. Lazy (the default): the shared prefixes
(``precompute_o_actv``, ``precompute_style_v``, ``shifted_mask_stack``),
then per group either ``o_branch_raw_hwnc`` + ``style_blend_chunk`` (one
``style_blend_dot`` giving the finished (γ, β)) or, on the masked path of
exact bucketed eval, ``style_chunk_dot`` (one ``style_dot_hwbm``) +
per-block ``o_branch_from_actv``. Hoisted: whole [B,H,W,N·2C] maps per
group, from ``hoisted_o_branch`` (two convs) or ``pallas_o_branch`` (the
``fused_o_branch`` kernel) and ``hoisted_style_branch`` (one matmul), or
the finished blend from ``hoisted_blended_mods`` (the ``fused_modulation``
kernel). A SEAN outside the trunk (blocks nb-2 / nb-1), and every SEAN
under ``remat_blocks``, runs its own two branches. The module then blends
and applies the modulation with one of three epilogues: pre-normalized
input, the fused InstanceNorm+modulation kernel (``fused_epilogue``), or
masked statistics.

The paper's two ablations change the module itself (``endosr/nn/sean.py``
``SEAN.setup`` / ``__call__``): ``ablate_depth_matrix`` takes the style
branch from two plain convs over the spatial latent of
``EncoderNoDepthMatrix`` (no ``A_i_j``); ``ablate_depth_block`` drops both
branches and the blend for ``mlp_depthMatrix`` (a transposed conv of the
style matrix seen as an L×L image of K channels), ``mlp_before_all`` over
it and the depth map's activation, and ``mlp_gamma_all`` /
``mlp_beta_all``.

Weights travel as plain tuples of HWIO fp32 tensors:
``depth_branch_weights()`` → (w_mask, b_mask, w_ob, b_ob) with w_ob the
γ‖β-concatenated [3,3,2C,2C] kernel; ``style_branch_weights()`` →
(a_w [K_in, K_out], a_b, w_gs, b_gs, w_bs, b_bs).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from endosr_torch.kernels.fused_in_mod import fused_in_mod
from endosr_torch.kernels.fused_mod import fused_modulation
from endosr_torch.kernels.fused_obranch import fused_o_branch
from endosr_torch.kernels.style_dot import style_blend_dot, style_dot_hwbm
from endosr_torch.nn.layers import (Conv, ConvTranspose, conv2d_nhwc, hwio,
                                    instance_norm, masked_instance_norm)
from endosr_torch.ops.resize import interpolate_nearest
from endosr_torch.utils.device import device_constant

__all__ = ["SEAN", "precompute_o_actv", "alpha_vec", "o_branch_raw_hwnc",
           "o_branch_from_actv", "style_blend_chunk", "style_chunk_dot",
           "precompute_style_v", "shifted_mask_stack", "hoisted_o_branch",
           "hoisted_style_branch", "pallas_o_branch", "hoisted_blended_mods"]


def _split_channels(x, n, c):
    """n equal channel chunks of width c (views)."""
    return tuple(x[..., i * c:(i + 1) * c] for i in range(n))


def _mask_conv_relu(d, w_mask, b_mask, dtype):
    """relu(conv3×3(d [B,h,w,1]) + bias) — the "conv" body."""
    return torch.relu(conv2d_nhwc(d, w_mask, 1, dtype) + b_mask.to(dtype))


def _o_actv(weights, depth_map, dtype, vmask):
    """relu(conv1(d)) of N instances as one 1→N·2C conv: [B,h,w,N·2C],
    instance-major, re-zeroed outside the valid region under ``vmask``."""
    w_mask = torch.cat([w[0].to(dtype) for w in weights], dim=-1)
    b_mask = torch.cat([w[1].to(dtype) for w in weights])
    actv = _mask_conv_relu(depth_map.to(dtype), w_mask, b_mask, dtype)
    return actv if vmask is None else actv * vmask.to(actv.dtype)


def precompute_o_actv(weights, depth_map, dtype, vmask=None):
    """Shared first o-branch stage of N instances: one 1→N·2C conv + ReLU,
    returned as per-instance [B,h,w,2C] chunks. ``vmask`` re-zeroes the
    activation outside the valid region (the branch is a conv chain, and
    relu(bias) in the padding would leak one pixel into the image)."""
    if not weights:
        return ()
    c2 = weights[0][2].shape[-1]
    return _split_channels(_o_actv(weights, depth_map, dtype, vmask),
                           len(weights), c2)


def _pairs(x, n, c):
    """[(γ_i, β_i)] views of an instance-major [..., N·2C] map."""
    halves = _split_channels(x, 2 * n, c)
    return [(halves[2 * i], halves[2 * i + 1]) for i in range(n)]


def hoisted_o_branch(weights, depth_map, dtype, vmask=None):
    """Every instance's depth-map branch in two convs: the 1→N·2C conv +
    ReLU, then one N-group 2C→2C conv + bias. Returns [(γ_o, β_o), ...] as
    views of the one [B,h,w,N·2C] map."""
    n = len(weights)
    if n == 0:
        return []
    c2 = weights[0][2].shape[-1]
    actv = _o_actv(weights, depth_map, dtype, vmask)
    w_ob = torch.cat([w[2].to(dtype) for w in weights], dim=-1)
    b_ob = torch.cat([w[3].to(dtype) for w in weights])
    ob = conv2d_nhwc(actv, w_ob, 1, dtype, groups=n) + b_ob
    return _pairs(ob, n, c2 // 2)


def pallas_o_branch(weights, depth_map, dtype):
    """:func:`hoisted_o_branch` (unmasked) through the ``fused_o_branch``
    kernel: same operands, stacked per instance, same return contract."""
    n = len(weights)
    if n == 0:
        return []
    c2 = weights[0][2].shape[-1]
    wm = torch.stack([w[0].reshape(9, c2).to(dtype) for w in weights])
    bm = torch.stack([w[1].to(dtype) for w in weights])
    w2 = torch.stack([w[2].reshape(9, c2, c2).to(dtype) for w in weights])
    b2 = torch.stack([w[3].to(dtype) for w in weights])
    ob = fused_o_branch(depth_map, wm, bm, w2, b2, dtype)
    return _pairs(ob, n, c2 // 2)


def alpha_vec(alphas, c, dtype):
    """Per-output-channel blend factors [2C] from a SEAN's (α_γ, α_β)."""
    ag, ab = alphas
    return torch.cat([ag.reshape(()).to(dtype).expand(c),
                      ab.reshape(()).to(dtype).expand(c)])


def o_branch_from_actv(actv_i, weight, dtype):
    """Per-instance second o-branch conv: [B,h,w,2C] → (γ_o, β_o)."""
    w_ob, b_ob = weight[2], weight[3]
    c = w_ob.shape[-1] // 2
    ob = conv2d_nhwc(actv_i, w_ob, 1, dtype) + b_ob.to(dtype)
    return ob[..., :c], ob[..., c:]


def o_branch_raw_hwnc(actv_i, weight, dtype, alphas):
    """(1−α)-scaled, bias-free second o-branch conv, as an [H,W,B,2C] view."""
    w_ob = weight[2]
    c = w_ob.shape[-1] // 2
    w_ob = w_ob * (1.0 - alpha_vec(alphas, c, w_ob.dtype))
    return conv2d_nhwc(actv_i, w_ob, 1, dtype).permute(1, 2, 0, 3)


def style_blend_chunk(shifted, v_list, weights, alphas, o_biases, convs_raw,
                      dtype):
    """Final blended (γ, β) of a group of SEAN instances through one
    ``style_blend_dot``: α-scaled style dot + (1−α)-scaled o-branch convs
    + α·b_s + (1−α)·b_o. Returns [(γ_i, β_i), ...] as [B,H,W,C] views."""
    c = weights[0][2].shape[-1]
    avs = [alpha_vec(a, c, v.dtype) for a, v in zip(alphas, v_list)]
    v = torch.cat([v * av[None, None, :] for v, av in zip(v_list, avs)], dim=-1)
    biases = []
    for i, w in enumerate(weights):
        b_s = torch.cat([w[3].to(dtype), w[5].to(dtype)])
        biases.append(avs[i] * b_s + (1.0 - avs[i]) * o_biases[i].to(dtype))
    bias = torch.cat(biases)
    y = style_blend_dot(shifted, v, tuple(convs_raw), bias).permute(2, 0, 1, 3)
    halves = _split_channels(y, 2 * len(weights), c)
    return [(halves[2 * i], halves[2 * i + 1]) for i in range(len(weights))]


def style_chunk_dot(shifted, v_list, weights, dtype, use_kernel=True):
    """One style dot for a group of SEAN instances: per-instance [B,9K,2C]
    kernels ``v_list`` against the shifted mask stack, plus each
    instance's style biases; through ``style_dot_hwbm`` or, with
    ``use_kernel`` off, a plain matmul. Returns [(γ_s, β_s), ...] as
    [B,H,W,C] views."""
    c = weights[0][2].shape[-1]
    v = torch.cat(list(v_list), dim=-1)                       # [B, 9K, G·2C]
    if use_kernel:
        y = style_dot_hwbm(shifted, v).permute(2, 0, 1, 3)
    else:
        y = torch.einsum("bhwj,bjm->bhwm", shifted, v)
    halves = _split_channels(y, 2 * len(weights), c)
    return [(halves[2 * i] + w[3].to(dtype), halves[2 * i + 1] + w[5].to(dtype))
            for i, w in enumerate(weights)]


def precompute_style_v(weights, st, dtype):
    """Per-instance per-tap per-bin style kernels [B, 9K, 2C] from the
    style matrix st [B,K,L] (the tiny-matmul half of the factored style
    modulation)."""
    if not weights:
        return ()
    n, c2 = len(weights), 2 * weights[0][2].shape[-1]
    v = _style_v(weights, st, dtype, "bxyknc")
    return _split_channels(v.reshape(v.shape[0], -1, n * c2), n, c2)


def _style_v(weights, st, dtype, out):
    """The style kernels of N instances from st [B,K,L], in the einsum
    index order ``out`` over (b, x, y: taps, k: bin, n: instance, c: 2C)."""
    st = st.to(dtype)
    a_w = torch.stack([w[0].to(dtype) for w in weights])          # [N,K,K]
    a_b = torch.stack([w[1].to(dtype) for w in weights])          # [N,K]
    st_mixed = (torch.einsum("njk,bjl->nbkl", a_w, st)
                + a_b[:, None, :, None])                          # [N,B,K,L]
    w_cat = torch.stack([torch.cat([w[2].to(dtype), w[4].to(dtype)], dim=-1)
                         for w in weights])                       # [N,3,3,L,2C]
    return torch.einsum(f"nbkl,nxylc->{out}", st_mixed, w_cat)


def hoisted_style_branch(weights, depth_mask, st, dtype):
    """Every instance's depth-matrix branch as one [B,HW,9K]×[B,9K,N·2C]
    product (a plain matmul, outside any kernel, as in the JAX package).
    Returns [(γ_s, β_s), ...]; the per-instance biases are added to the
    slices, so the whole map is not written a second time."""
    n = len(weights)
    if n == 0:
        return []
    c = weights[0][2].shape[-1]
    v = _style_v(weights, st, dtype, "bxyknc")
    v = v.reshape(v.shape[0], -1, n * 2 * c)
    y = torch.einsum("bhwj,bjm->bhwm", shifted_mask_stack(depth_mask, dtype), v)
    return [(g + w[3].to(dtype), b + w[5].to(dtype))
            for (g, b), w in zip(_pairs(y, n, c), weights)]


def hoisted_blended_mods(o_weights, s_weights, alphas, depth_map, depth_mask,
                         st, dtype):
    """The finished blended (γ, β) of every instance from one
    ``fused_modulation`` launch. The α blend and the four biases are folded
    into the operands: out = shifted@(α·v) + conv2(relu(conv1(d));
    (1−α)·w2) + [α·b_s + (1−α)·b_o]."""
    n = len(o_weights)
    if n == 0:
        return []
    c2 = o_weights[0][2].shape[-1]
    c = c2 // 2
    av = torch.stack([alpha_vec(a, c, dtype) for a in alphas])    # [N, 2C]
    wm = torch.stack([w[0].reshape(9, c2).to(dtype) for w in o_weights])
    bm = torch.stack([w[1].to(dtype) for w in o_weights])
    w2 = (torch.stack([w[2].reshape(9 * c2, c2).to(dtype) for w in o_weights])
          * (1.0 - av)[:, None, :])
    v = _style_v(s_weights, st, dtype, "bnxykc")
    v = v.reshape(v.shape[0], n, -1, c2) * av[None, :, None, :]
    b_s = torch.stack([torch.cat([w[3].to(dtype), w[5].to(dtype)])
                       for w in s_weights])
    b_o = torch.stack([w[3].to(dtype) for w in o_weights])
    bias = av * b_s + (1.0 - av) * b_o
    out = fused_modulation(depth_map.to(dtype), depth_mask.to(dtype), wm, bm,
                           w2, v, bias, dtype)
    return _pairs(out, n, c)


def shifted_mask_stack(depth_mask, dtype):
    """9 shifted copies of the K-channel mask stack → [B,H,W,9K]
    (τ-major, then k), built as one 0/1 conv."""
    eye = device_constant(_shift_eye, (depth_mask.shape[-1],), dtype,
                          depth_mask.device)
    return conv2d_nhwc(depth_mask.to(dtype), eye, 1, dtype)


def _shift_eye(k: int) -> np.ndarray:
    """0/1 [3, 3, K, 9K] kernel copying bin k at tap (dy, dx) to channel
    (dy·3 + dx)·K + k."""
    eye = np.zeros((3, 3, k, 9 * k), np.float32)
    for dy in range(3):
        for dx in range(3):
            for kk in range(k):
                eye[dy, dx, kk, (dy * 3 + dx) * k + kk] = 1.0
    return eye


class SEAN(nn.Module):
    """SEAN parameters (reference names) and its modulation epilogue; with
    ``ablate_depth_matrix`` or ``ablate_depth_block`` the ablated module
    of the JAX package (see the module's docstring)."""

    def __init__(self, label_nc=10, norm_nc=64, len_latent=256,
                 use_trainable_params=True, norm_gamma=0.1, norm_beta=0.1,
                 ablate_depth_matrix=False, ablate_depth_block=False,
                 device=None):
        super().__init__()
        c, k, l = norm_nc, label_nc, len_latent
        self.ablate_depth_matrix = bool(ablate_depth_matrix)
        self.ablate_depth_block = bool(ablate_depth_block)
        # the depth-block ablation has no blend, so no α
        self.use_trainable_params = (use_trainable_params
                                     and not self.ablate_depth_block)
        self.norm_gamma, self.norm_beta = norm_gamma, norm_beta
        self.mlp_mask = nn.ModuleDict({"0": Conv(1, 2 * c, 3, device=device)})
        if self.ablate_depth_block:
            self.mlp_depthMatrix = ConvTranspose(k, k, 3, 2, 1, device=device)
            self.mlp_before_all = Conv(k + 2 * c, c, 3, device=device)
            self.mlp_gamma_all = Conv(c, c, 3, device=device)
            self.mlp_beta_all = Conv(c, c, 3, device=device)
            return
        self.mlp_gamma_o = Conv(2 * c, c, 3, device=device)
        self.mlp_beta_o = Conv(2 * c, c, 3, device=device)
        if not self.ablate_depth_matrix:
            self.A_i_j = Conv(k, k, 1, padding=0, device=device)
        self.mlp_gamma_s = Conv(l, c, 3, device=device)
        self.mlp_beta_s = Conv(l, c, 3, device=device)
        if self.use_trainable_params:
            self.alpha_gamma = nn.Parameter(torch.empty(1, device=device))
            self.alpha_beta = nn.Parameter(torch.empty(1, device=device))

    def init_(self, gen):
        for m in self.children():
            for leaf in (m.values() if isinstance(m, nn.ModuleDict) else (m,)):
                leaf.init_(gen)
        if self.use_trainable_params:
            with torch.no_grad():  # torch.rand(1): U[0, 1)
                self.alpha_gamma.copy_(torch.rand(1, generator=gen))
                self.alpha_beta.copy_(torch.rand(1, generator=gen))

    def depth_branch_weights(self):
        m = self.mlp_mask["0"]
        w_ob = torch.cat([hwio(self.mlp_gamma_o.weight),
                          hwio(self.mlp_beta_o.weight)], dim=-1)
        b_ob = torch.cat([self.mlp_gamma_o.bias, self.mlp_beta_o.bias])
        return hwio(m.weight), m.bias, w_ob, b_ob

    def style_branch_weights(self):
        return (self.A_i_j.weight[:, :, 0, 0].t(), self.A_i_j.bias,
                hwio(self.mlp_gamma_s.weight), self.mlp_gamma_s.bias,
                hwio(self.mlp_beta_s.weight), self.mlp_beta_s.bias)

    def blend_alphas(self):
        if self.use_trainable_params:
            return self.alpha_gamma, self.alpha_beta
        dev = self.mlp_mask["0"].weight.device
        return tuple(device_constant(np.full, ((1,), v), torch.float32, dev)
                     for v in (self.norm_gamma, self.norm_beta))

    def forward(self, x, depth_map, depth_mask, st, dtype, ob=None, sb=None,
                mod=None, pre_normalized=False, vmask=None,
                fused_epilogue=False):
        """x [B,h,w,C]; depth_map [B,H,W,1]; depth_mask [B,H,W,K]; st
        [B,K,L]. ``mod``: finished (γ, β). ``ob``/``sb``: precomputed
        (γ_o, β_o) / (γ_s, β_s) at x's resolution; a missing one is computed
        here from the depth inputs. ``pre_normalized``: the caller already
        ran this SEAN's parameter-free norm (``chained_instance_norm``).
        ``vmask``: valid-region mask of exact bucketed eval (masked
        statistics, output re-zeroed outside it). ``fused_epilogue``:
        normalize and modulate in the ``fused_in_mod`` kernel."""
        if mod is None:
            mod = self._modulation(x, depth_map, depth_mask, st, dtype, ob, sb,
                                   vmask)
        gamma, beta = mod
        if pre_normalized:
            y = x * (1 + gamma) + beta
            return y if vmask is None else y * vmask.to(y.dtype)
        if fused_epilogue and vmask is None:
            return fused_in_mod(x, gamma, beta)
        if vmask is not None:
            y = masked_instance_norm(x, vmask) * (1 + gamma) + beta
            return y * vmask.to(y.dtype)
        return instance_norm(x) * (1 + gamma) + beta

    def _modulation(self, x, depth_map, depth_mask, st, dtype, ob, sb, vmask):
        """Blended (γ, β) = α·(γ_s, β_s) + (1−α)·(γ_o, β_o); with
        ``ablate_depth_matrix`` the style branch is two convs over the
        spatial latent ``st`` [B,h,w,L]; with ``ablate_depth_block`` see
        :meth:`_depth_block_ablation`."""
        size = (x.shape[1], x.shape[2])
        if self.ablate_depth_block:
            return self._depth_block_ablation(size, depth_map, st, dtype)
        if ob is None:
            w_mask, b_mask, w_ob, b_ob = self.depth_branch_weights()
            d = interpolate_nearest(depth_map, size)
            actv, = precompute_o_actv([(w_mask, b_mask, w_ob, b_ob)], d, dtype,
                                      vmask)
            ob = o_branch_from_actv(actv, (w_mask, b_mask, w_ob, b_ob), dtype)
        if sb is None and self.ablate_depth_matrix:
            sb = (self.mlp_gamma_s(st, dtype), self.mlp_beta_s(st, dtype))
        elif sb is None:
            sw = self.style_branch_weights()
            mask = interpolate_nearest(depth_mask, size).to(dtype)
            v, = precompute_style_v([sw], st, dtype)
            # outside the trunk groups: a plain product, no kernel
            y = torch.einsum("bhwj,bjm->bhwm", shifted_mask_stack(mask, dtype), v)
            c = sw[2].shape[-1]
            sb = (y[..., :c] + sw[3].to(dtype), y[..., c:] + sw[5].to(dtype))
        ag, ab = (a.to(dtype) for a in self.blend_alphas())
        return (ag * sb[0] + (1.0 - ag) * ob[0],
                ab * sb[1] + (1.0 - ab) * ob[1])

    def _depth_block_ablation(self, size, depth_map, st, dtype):
        """(γ, β) of the depth-block ablation: the depth map's activation
        relu(mlp_mask(d)) [B,h,w,2C] beside ``mlp_depthMatrix`` of the style
        matrix st [B,K,L] read as an L×L image of K channels (row l holds
        st[:, :, l] in every column), resized nearest to the feature's
        size; ``mlp_before_all`` over both, then ``mlp_gamma_all`` and
        ``mlp_beta_all``. No blend."""
        d = interpolate_nearest(depth_map, size).to(dtype)
        actv = torch.relu(self.mlp_mask["0"](d, dtype))
        lat = st.shape[2]
        dup = st[..., None].expand(*st.shape, lat).permute(0, 2, 3, 1)
        down = interpolate_nearest(self.mlp_depthMatrix(dup, dtype), size)
        cat = self.mlp_before_all(torch.cat([down, actv], dim=-1), dtype)
        return self.mlp_gamma_all(cat, dtype), self.mlp_beta_all(cat, dtype)
