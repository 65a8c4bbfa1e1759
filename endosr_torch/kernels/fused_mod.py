"""Fused blended SEAN modulation of N instances.

Port of ``endosr/kernels/fused_mod.py::fused_modulation`` (TPU kernel
``pallas_call`` at ``:152``, twin ``fused_modulation_reference`` at ``:40``):

    out[b,y,x, n·2C+c] = conv3×3(relu(conv3×3(d; wm_n) + bm_n); w2_n)[c]
                       + Σ_{tap,k} mask[b, y+dy−1, x+dx−1, k] · v[b,n,tap·K+k,c]
                       + bias_n[c]

with the α blend and the four biases already folded into w2, v and bias
(``endosr_torch.nn.sean.hoisted_blended_mods``). The CUDA kernels
(``endosr_torch/csrc/fused_mod.cu``) are the ``fused_o_branch`` kernels
with nine more products after the nine conv2 taps: the mask's halo tile (K
zero-padded to 16) is the A operand, each tap's shifted window multiplied
with that tap's K rows of this image's and instance's v, into the same fp32
accumulators. The activation is rounded once to the storage type after the
ReLU, and the o-branch, the style product and the bias are summed in fp32
before the one final rounding, as the TPU kernel does. It is bound by
operations (2·B·H·W·N·(9·2C + 9K)·2C ≈ 1.1 TFLOP at the flagship shape);
the style part (K = 90 of 1242) has another right-hand side for every
image. No PyTorch call computes the same function.

:func:`fused_modulation_route` picks the kernel by shape, never by trial:
``"wgmma"`` (bf16, 2C = 64 or 128, K ≤ 16, 16-byte aligned operands; v
streams through the weight ring as three tiles a tile, packed once per call
by :func:`style_pack_v`), ``"mma"`` (any other bf16 shape) or ``"fp32"``
(float32 storage). ``fused_modulation.launches`` counts launches,
``fused_modulation.routes`` counts them per route.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from endosr_torch.kernels import _build
from endosr_torch.kernels._autograd import differentiable, twin_vjp
from endosr_torch.kernels.fused_obranch import (acc_dtype, check_o_operands,
                                                conv1_twin,
                                                fused_o_branch_route,
                                                grouped_w2, o_actv_plain,
                                                o_branch_pack_weights,
                                                promoted)
from endosr_torch.utils.device import device_constant
from endosr_torch.utils.prof import annotate

__all__ = ["fused_modulation", "fused_modulation_plain",
           "fused_modulation_route", "fused_modulation_twin",
           "fused_modulation_vjp", "style_pack_index", "style_pack_v",
           "style_unpack_v", "launch_mma", "launch_wgmma"]


def fused_modulation_plain(d, mask, wm, bm, w2, v, bias, out_dtype=None):
    """Plain PyTorch version. d [B,H,W,1]; mask [B,H,W,K]; wm [N,9,2C]; bm
    [N,2C]; w2 [N,9·2C,2C]; v [B,N,9K,2C]; bias [N,2C] → [B,H,W,N·2C].
    Operands are rounded to the storage type; both products and the bias
    add run in the accumulation type, with one rounding at the end."""
    n, _, c2 = wm.shape
    b, h, w, _ = mask.shape
    dt = out_dtype or d.dtype
    ct = acc_dtype(dt)
    actv = o_actv_plain(d, wm, bm, dt).to(ct)
    o = F.conv2d(actv.permute(0, 3, 1, 2),
                 grouped_w2(w2.to(dt).to(ct), n, c2), padding=1, groups=n)
    style = torch.einsum("bhwj,bnjc->bhwnc", _shifted(mask.to(dt).to(ct)),
                         v.to(dt).to(ct))
    out = (o.permute(0, 2, 3, 1) + style.reshape(b, h, w, n * c2)
           + bias.to(dt).to(ct).reshape(-1))
    return out.to(dt)


def _shifted(mask):
    """The 9 shifted copies of ``mask`` [B,H,W,K] → [B,H,W,9K], zero
    outside, tap-major."""
    h, w = mask.shape[1], mask.shape[2]
    mp = F.pad(mask, (0, 0, 1, 1, 1, 1))
    return torch.cat([mp[:, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], dim=-1)


def fused_modulation_twin(d, mask, wm, bm, w2, v, bias, out_dtype=None):
    """The JAX twin's op order (``fused_mod.py:40``), lowered as convs:
    conv1 + bias + ReLU, conv2 and the style product each in its operands'
    promoted type, then (conv2 + style) + bias, rounded to the output type
    once. In fp32 it is :func:`fused_modulation_plain`; in bf16 it rounds
    where the twin does (after each product and add), where the plain
    version (as the kernel) sums in fp32 and rounds once."""
    n, _, c2 = wm.shape
    b, h, w, _ = mask.shape
    dt = out_dtype or d.dtype
    a_, w_ = promoted(conv1_twin(d, wm, bm), w2)
    o = F.conv2d(a_, grouped_w2(w_, n, c2), padding=1, groups=n)
    s_, v_ = promoted(_shifted(mask), v)
    style = torch.einsum("bhwj,bnjc->bhwnc", s_, v_).reshape(b, h, w, n * c2)
    o, style = promoted(o.permute(0, 2, 3, 1), style)
    out, b_ = promoted(o + style, bias)
    return (out + b_.reshape(-1)).to(dt)


def fused_modulation_vjp(d, mask, wm, bm, w2, v, bias, g, out_dtype=None):
    """The backward of :func:`fused_modulation` (the JAX ``_bwd``,
    ``fused_mod.py:196-202``): the VJP of the twin
    (:func:`fused_modulation_twin`). Returns the gradients of (d, mask,
    wm, bm, w2, v, bias)."""
    with annotate("kernel.fused_modulation_vjp"):
        return twin_vjp(
            lambda *a: fused_modulation_twin(*a, out_dtype=out_dtype),
            (d, mask, wm, bm, w2, v, bias), g)


def fused_modulation_route(dtype, c2, k, ptrs):
    """Which kernel a CUDA call takes: ``"wgmma"``, ``"mma"`` or ``"fp32"``
    (:func:`fused_o_branch_route` with the K ≤ 16 of the style k-step)."""
    return fused_o_branch_route(dtype, c2, ptrs, k)


def style_pack_index(k, c2):
    """Flat indices into one (image, instance)'s v [9K, 2C] with one zero
    appended (index 9K·2C) of the order the ``wgmma`` kernel streams, [3
    tiles, 2C o, 8 pieces, 8]: tile u holds taps 4u .. 4u+3 as k-steps of
    16, kk = 16·(tap % 4) + k, zero for k ≥ K and tap ≥ 9; the piece
    stored at position j of row o is the logical piece j ^ (o & 7)."""
    u, o, j, q = np.meshgrid(np.arange(3), np.arange(c2), np.arange(8),
                             np.arange(8), indexing="ij")
    kk = (j ^ (o & 7)) * 8 + q
    tap, kb = 4 * u + kk // 16, kk % 16
    idx = (tap * k + kb) * c2 + o
    return np.where((tap < 9) & (kb < k), idx, 9 * k * c2).reshape(-1)


def style_pack_v(v):
    """v [B, N, 9K, 2C] → [B, N, 3, 2C, 64]: the style taps' B tiles of the
    ``wgmma`` kernel. One gather."""
    b, n, k9, c2 = v.shape
    idx = device_constant(style_pack_index, (k9 // 9, c2), torch.int64,
                          v.device)
    flat = torch.cat([v.reshape(b * n, k9 * c2),
                      v.new_zeros(b * n, 1)], dim=1)
    return flat[:, idx].reshape(b, n, 3, c2, 64)


def style_unpack_v(packed, k):
    """Inverse of :func:`style_pack_v` on its non-zero places: → v
    [B, N, 9K, 2C]."""
    b, n, _, c2, _ = packed.shape
    idx = device_constant(style_pack_index, (k, c2), torch.int64,
                          packed.device)
    flat = torch.empty((b * n, 9 * k * c2 + 1), dtype=packed.dtype,
                       device=packed.device)
    flat[:, idx] = packed.reshape(b * n, -1)
    return flat[:, :-1].reshape(b, n, 9 * k, c2)


def _mod_prepare(d, mask, wm, bm, w2, v, bias, out_dtype):
    b, h, w, n, c2 = check_o_operands(d, wm, bm, w2, bias)
    k = mask.shape[3]
    if tuple(mask.shape) != (b, h, w, k) or tuple(v.shape) != (b, n, 9 * k, c2):
        raise ValueError(f"mask {tuple(mask.shape)} and v {tuple(v.shape)} "
                         f"must be [{b},{h},{w},K] and [{b},{n},9K,{c2}]")
    if k > 16:
        raise ValueError(f"the kernel takes K ≤ 16 depth bins, got {k}")
    dt = out_dtype or d.dtype
    dd, mm = d.to(dt).contiguous(), mask.to(dt).contiguous()
    ops = [t.to(dt).contiguous() for t in (wm, bm, w2, v, bias)]
    out = torch.empty((b, h, w, n * c2), dtype=dt, device=d.device)
    return (b, h, w, n, c2, k), dt, dd, mm, ops, out


def launch_mma(d, mask, wm, bm, w2, v, bias, out_dtype=None):
    """Launch the tile kernel (routes ``"mma"`` and ``"fp32"``) on CUDA
    operands; counts nothing."""
    fn = _build.load("fused_mod")
    (b, h, w, n, c2, k), dt, dd, mm, ops, out = _mod_prepare(
        d, mask, wm, bm, w2, v, bias, out_dtype)
    code = fn(_build.dtype_code(dt), dd.data_ptr(), mm.data_ptr(),
              *(t.data_ptr() for t in ops), out.data_ptr(), b, h, w, n, c2, k,
              _build.stream_ptr(d.device))
    _build.check("fused_mod", code)
    return out


def launch_wgmma(d, mask, wm, bm, w2, v, bias, out_dtype=None,
                 lib="fused_mod"):
    """Launch the ``wgmma`` kernel (route ``"wgmma"``) on CUDA operands;
    counts nothing. ``lib``: the library that exports ``fused_mod_wgmma``."""
    fn = _build.load(lib, "fused_mod_wgmma")
    (b, h, w, n, c2, k), dt, dd, mm, (wm_, bm_, w2_, v_, bias_), out = \
        _mod_prepare(d, mask, wm, bm, w2, v, bias, out_dtype)
    with annotate("net.prepare"):
        wp, vp = o_branch_pack_weights(w2_), style_pack_v(v_)
    code = fn(1, dd.data_ptr(), mm.data_ptr(), wm_.data_ptr(), bm_.data_ptr(),
              wp.data_ptr(), vp.data_ptr(), bias_.data_ptr(), out.data_ptr(),
              b, h, w, n, c2, k, _build.stream_ptr(d.device))
    _build.check(lib, code, "fused_mod_wgmma")
    return out


def fused_modulation(d, mask, wm, bm, w2, v, bias, out_dtype=None):
    """The finished blended (γ, β) maps of N SEAN instances in one pass →
    [B,H,W,N·2C] in ``out_dtype`` (default ``d.dtype``).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`fused_modulation_route` names (and raises if it
    cannot). Under autograd the backward is :func:`fused_modulation_vjp`."""
    with annotate("kernel.fused_modulation"):
        return differentiable(
            lambda *a: _forward(*a, out_dtype),
            lambda saved, g: fused_modulation_vjp(*saved, g, out_dtype),
            (d, mask, wm, bm, w2, v, bias))


def _forward(d, mask, wm, bm, w2, v, bias, out_dtype):
    if d.device.type == "cpu":
        return fused_modulation_plain(d, mask, wm, bm, w2, v, bias, out_dtype)
    c2 = check_o_operands(d, wm, bm, w2, bias)[4]
    route = fused_modulation_route(
        out_dtype or d.dtype, c2, mask.shape[3],
        [t.data_ptr() for t in (d, mask, wm, bm, w2, v, bias)])
    launch = launch_wgmma if route == "wgmma" else launch_mma
    out = launch(d, mask, wm, bm, w2, v, bias, out_dtype)
    fused_modulation.launches += 1
    fused_modulation.routes[route] += 1
    return out


fused_modulation.launches = 0
fused_modulation.routes = {"wgmma": 0, "mma": 0, "fp32": 0}
