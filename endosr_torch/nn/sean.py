"""SEAN depth-conditioned normalization — the serving subset of the port.

Counterpart of ``endosr/nn/sean.py``. The flagship forward never runs a
SEAN's own branches: DepthNet evaluates every trunk instance's depth-map
branch (o) and depth-matrix branch (s) up front in the lazy, grouped form
(``precompute_o_actv``, ``precompute_style_v``, ``shifted_mask_stack``,
then per group ``o_branch_raw_hwnc`` + ``style_blend_chunk``), and the
SEAN module applies the finished (γ, β) to an already normalized input.
Only that path is ported; the module's parameters are complete, so a
reference checkpoint loads.

Weights travel as plain tuples of HWIO fp32 tensors:
``depth_branch_weights()`` → (w_mask, b_mask, w_ob, b_ob) with w_ob the
γ‖β-concatenated [3,3,2C,2C] kernel; ``style_branch_weights()`` →
(a_w [K_in, K_out], a_b, w_gs, b_gs, w_bs, b_bs).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from endosr_torch.kernels.style_dot import style_blend_dot
from endosr_torch.nn.layers import Conv, conv2d_nhwc, hwio
from endosr_torch.utils.device import device_constant

__all__ = ["SEAN", "precompute_o_actv", "alpha_vec", "o_branch_raw_hwnc",
           "style_blend_chunk", "precompute_style_v", "shifted_mask_stack"]


def _split_channels(x, n, c):
    """n equal channel chunks of width c (views)."""
    return tuple(x[..., i * c:(i + 1) * c] for i in range(n))


def _mask_conv_relu(d, w_mask, b_mask, dtype):
    """relu(conv3×3(d [B,h,w,1]) + bias) — the "conv" body."""
    return torch.relu(conv2d_nhwc(d, w_mask, 1, dtype) + b_mask.to(dtype))


def precompute_o_actv(weights, depth_map, dtype):
    """Shared first o-branch stage of N instances: one 1→N·2C conv + ReLU,
    returned as per-instance [B,h,w,2C] chunks."""
    if not weights:
        return ()
    c2 = weights[0][2].shape[-1]
    w_mask = torch.cat([w[0].to(dtype) for w in weights], dim=-1)
    b_mask = torch.cat([w[1].to(dtype) for w in weights])
    actv = _mask_conv_relu(depth_map.to(dtype), w_mask, b_mask, dtype)
    return _split_channels(actv, len(weights), c2)


def alpha_vec(alphas, c, dtype):
    """Per-output-channel blend factors [2C] from a SEAN's (α_γ, α_β)."""
    ag, ab = alphas
    return torch.cat([ag.reshape(()).to(dtype).expand(c),
                      ab.reshape(()).to(dtype).expand(c)])


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


def precompute_style_v(weights, st, dtype):
    """Per-instance per-tap per-bin style kernels [B, 9K, 2C] from the
    style matrix st [B,K,L] (the tiny-matmul half of the factored style
    modulation)."""
    if not weights:
        return ()
    b, k, _ = st.shape
    n = len(weights)
    c = weights[0][2].shape[-1]
    st = st.to(dtype)
    a_w = torch.stack([w[0].to(dtype) for w in weights])          # [N,K,K]
    a_b = torch.stack([w[1].to(dtype) for w in weights])          # [N,K]
    st_mixed = (torch.einsum("njk,bjl->nbkl", a_w, st)
                + a_b[:, None, :, None])                          # [N,B,K,L]
    w_cat = torch.stack([torch.cat([w[2].to(dtype), w[4].to(dtype)], dim=-1)
                         for w in weights])                       # [N,3,3,L,2C]
    v = torch.einsum("nbkl,nxylc->bxyknc", st_mixed, w_cat)
    v = v.reshape(b, 9 * k, n * 2 * c)
    return _split_channels(v, n, 2 * c)


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
    """SEAN parameters (reference names) and its modulation epilogue."""

    def __init__(self, label_nc=10, norm_nc=64, len_latent=256,
                 use_trainable_params=True, norm_gamma=0.1, norm_beta=0.1,
                 device=None):
        super().__init__()
        c, k, l = norm_nc, label_nc, len_latent
        self.use_trainable_params = use_trainable_params
        self.norm_gamma, self.norm_beta = norm_gamma, norm_beta
        self.mlp_mask = nn.ModuleDict({"0": Conv(1, 2 * c, 3, device=device)})
        self.mlp_gamma_o = Conv(2 * c, c, 3, device=device)
        self.mlp_beta_o = Conv(2 * c, c, 3, device=device)
        self.A_i_j = Conv(k, k, 1, padding=0, device=device)
        self.mlp_gamma_s = Conv(l, c, 3, device=device)
        self.mlp_beta_s = Conv(l, c, 3, device=device)
        if use_trainable_params:
            self.alpha_gamma = nn.Parameter(torch.empty(1, device=device))
            self.alpha_beta = nn.Parameter(torch.empty(1, device=device))

    def init_(self, gen):
        for m in (self.mlp_mask["0"], self.mlp_gamma_o, self.mlp_beta_o,
                  self.A_i_j, self.mlp_gamma_s, self.mlp_beta_s):
            m.init_(gen)
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
        dev = self.A_i_j.weight.device
        return tuple(device_constant(np.full, ((1,), v), torch.float32, dev)
                     for v in (self.norm_gamma, self.norm_beta))

    def forward(self, x, mod):
        """x·(1+γ) + β for an x whose normalization the caller already ran
        (``chained_instance_norm``) and a finished ``mod`` = (γ, β)."""
        gamma, beta = mod
        return x * (1 + gamma) + beta
