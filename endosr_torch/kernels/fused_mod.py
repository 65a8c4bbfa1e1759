"""Fused blended SEAN modulation of N instances.

Port of ``endosr/kernels/fused_mod.py::fused_modulation`` (TPU kernel
``pallas_call`` at ``:152``, twin ``fused_modulation_reference`` at ``:40``):

    out[b,y,x, n·2C+c] = conv3×3(relu(conv3×3(d; wm_n) + bm_n); w2_n)[c]
                       + Σ_{tap,k} mask[b, y+dy−1, x+dx−1, k] · v[b,n,tap·K+k,c]
                       + bias_n[c]

with the α blend and the four biases already folded into w2, v and bias
(``endosr_torch.nn.sean.hoisted_blended_mods``). The CUDA kernel
(``endosr_torch/csrc/fused_mod.cu``) is the ``fused_o_branch`` kernel with
nine more products appended to the nine conv2 taps: the mask's halo tile
(K zero-padded to 16) takes the activation's place in shared memory and
each tap's shifted window is multiplied with that tap's K rows of this
image's and instance's v, into the same fp32 accumulators. The
activation is rounded once to the storage type after the ReLU, and the
o-branch, the style product and the bias are summed in fp32 before the one
final rounding, as the TPU kernel does. It is bound by operations
(2·B·H·W·N·(9·2C + 9K)·2C ≈ 1.1 TFLOP at the flagship shape); the style
part (K = 90 of 1242) has another right-hand side for every image. No
PyTorch call computes the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from endosr_torch.kernels import _build
from endosr_torch.kernels.fused_obranch import (acc_dtype, check_o_operands,
                                                grouped_w2, o_actv_plain)

__all__ = ["fused_modulation", "fused_modulation_plain"]


def fused_modulation_plain(d, mask, wm, bm, w2, v, bias, out_dtype=None):
    """Plain PyTorch version. d [B,H,W,1]; mask [B,H,W,K]; wm [N,9,2C]; bm
    [N,2C]; w2 [N,9·2C,2C]; v [B,N,9K,2C]; bias [N,2C] → [B,H,W,N·2C].
    Operands are rounded to the storage type; both products and the bias
    add run in the accumulation type, with one rounding at the end."""
    n, _, c2 = wm.shape
    b, h, w, k = mask.shape
    dt = out_dtype or d.dtype
    ct = acc_dtype(dt)
    actv = o_actv_plain(d, wm, bm, dt).to(ct)
    o = F.conv2d(actv.permute(0, 3, 1, 2),
                 grouped_w2(w2.to(dt).to(ct), n, c2), padding=1, groups=n)
    mp = F.pad(mask.to(dt).to(ct), (0, 0, 1, 1, 1, 1))
    shifted = torch.cat([mp[:, dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)], dim=-1)
    style = torch.einsum("bhwj,bnjc->bhwnc", shifted, v.to(dt).to(ct))
    out = (o.permute(0, 2, 3, 1) + style.reshape(b, h, w, n * c2)
           + bias.to(dt).to(ct).reshape(-1))
    return out.to(dt)


def fused_modulation(d, mask, wm, bm, w2, v, bias, out_dtype=None):
    """The finished blended (γ, β) maps of N SEAN instances in one pass →
    [B,H,W,N·2C] in ``out_dtype`` (default ``d.dtype``).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot)."""
    if d.device.type == "cpu":
        return fused_modulation_plain(d, mask, wm, bm, w2, v, bias, out_dtype)
    fn = _build.load("fused_mod")
    b, h, w, n, c2 = check_o_operands(d, wm, bm, w2, bias)
    k = mask.shape[3]
    if tuple(mask.shape) != (b, h, w, k) or tuple(v.shape) != (b, n, 9 * k, c2):
        raise ValueError(f"mask {tuple(mask.shape)} and v {tuple(v.shape)} "
                         f"must be [{b},{h},{w},K] and [{b},{n},9K,{c2}]")
    if k > 16:
        raise ValueError(f"the kernel takes K ≤ 16 depth bins, got {k}")
    dt, dev = out_dtype or d.dtype, d.device
    dd, mm = d.to(dt).contiguous(), mask.to(dt).contiguous()
    ops = [t.to(dt).contiguous() for t in (wm, bm, w2, v, bias)]
    out = torch.empty((b, h, w, n * c2), dtype=dt, device=dev)
    code = fn(_build.dtype_code(dt), dd.data_ptr(), mm.data_ptr(),
              *(t.data_ptr() for t in ops), out.data_ptr(), b, h, w, n, c2, k,
              _build.stream_ptr(dev))
    _build.check("fused_mod", code)
    fused_modulation.launches += 1
    return out


fused_modulation.launches = 0
