"""Fused ×8 tail head: folded head conv → clamp → PixelShuffle(4) → fp32 rows.

Port of ``endosr/kernels/fused_tail.py::fused_tail`` (TPU kernel
``pallas_call`` at ``:238``, twin ``fused_tail_reference`` at ``:94``). From
the packed tail's last tensor g4 (already activated and gated, with zero
columns beyond ``wout``):

    pre[b,y,x,o] = Σ_{dy,dx,c} g4[b, y+dy−1, x+dx−1, c] · wh[dy,dx,c,o] + bh[o]
    out[b, 4y+i, (4x+j)·3 + c] = float(clamp(pre[b,y,x, c·16 + i·4 + j]))

for y < Hp−1, x < wout, zero padding above and left. The CUDA kernel
(``endosr_torch/csrc/fused_tail.cu``) is the package's implicit-GEMM conv
(warp-level bf16 ``mma`` or the fp32 CUDA-core loop) whose epilogue rounds
the sum, adds the bias, clamps in the storage type and writes the fp32
pixel straight into its place in the shuffled image, so neither ``pre`` nor
an embedded 64-channel copy reaches device memory. The wrapper reorders the
48 output channels to i·12 + j·3 + c, so one pixel's twelve values of an
output row are neighbours. It is bound by operations
(2·B·h·wout·9·C4·48 ≈ 232 GFLOP at the flagship shape; the bytes, g4 once
and the image once, are close behind). The TPU kernel is square-only and
needs its column count aligned; this one takes any h, wout. Its strip DMA,
tap-stacked lanes and one-hot scatter are not copied.
"""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.kernels import _build
from endosr_torch.kernels.output_stage import output_stage_plain
from endosr_torch.nn.layers import conv2d_nhwc
from endosr_torch.utils.device import device_constant

__all__ = ["fused_tail", "fused_tail_plain"]


def _row_major_channels() -> np.ndarray:
    """[48]: the canonical PS(4) channel c·16 + i·4 + j at slot i·12 + j·3 + c."""
    m = np.arange(48)
    i, j, c = m // 12, (m % 12) // 3, m % 3
    return c * 16 + i * 4 + j


def fused_tail_plain(g4, wh, bh, clamp_min=0.0, clamp_max=1.0, layout="bhwc",
                     wout=None):
    """Plain PyTorch version: head conv (pad (1,0),(1,0)) cropped to
    ``wout`` columns + bias → clamp → PixelShuffle(4) → fp32
    [B, 4·(Hp−1), 12·wout]."""
    if layout == "hwbc":
        g4 = g4.permute(2, 0, 1, 3)
    dt = g4.dtype
    wout = g4.shape[1] - 1 if wout is None else wout
    pre = conv2d_nhwc(g4, wh, ((1, 0), (1, 0)), dt)[:, :, :wout] + bh.to(dt)
    return output_stage_plain(pre, 4, clamp_min, clamp_max)


def fused_tail(g4, wh, bh, clamp_min=0.0, clamp_max=1.0, layout="bhwc",
               wout=None):
    """g4 [B,Hp,Wc,C4] (``layout="bhwc"``) or [Hp,Wc,B,C4] (``"hwbc"``), wh
    [3,3,C4,48] in canonical PS(4) output order, bh [48] → [B, 4·(Hp−1),
    12·wout] fp32 (``wout`` defaults to Hp−1; Wc > wout).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot)."""
    if g4.device.type == "cpu":
        return fused_tail_plain(g4, wh, bh, clamp_min, clamp_max, layout, wout)
    fn = _build.load("fused_tail")
    if layout == "hwbc":
        hp, wc, b, c4 = g4.shape
        sh, sw, sb = g4.stride(0), g4.stride(1), g4.stride(2)
    else:
        b, hp, wc, c4 = g4.shape
        sb, sh, sw = g4.stride(0), g4.stride(1), g4.stride(2)
    h = hp - 1
    wout = h if wout is None else wout
    if (g4.stride(3) != 1 or c4 % 16 or wc <= wout
            or tuple(wh.shape) != (3, 3, c4, 48) or bh.numel() != 48):
        raise ValueError(
            f"g4 {tuple(g4.shape)} ({layout}) strides {g4.stride()}, wh "
            f"{tuple(wh.shape)}: channels must be contiguous and a multiple "
            "of 16, Wc > wout, and the head [3,3,C4,48]")
    dt, dev = g4.dtype, g4.device
    perm = device_constant(_row_major_channels, (), torch.int64, dev)
    w = wh.to(dt)[..., perm].contiguous()
    bias = bh.float()[perm].contiguous()
    out = torch.empty((b, 4 * h, 12 * wout), dtype=torch.float32, device=dev)
    code = fn(_build.dtype_code(dt), g4.data_ptr(), sh, sw, sb, b, c4, h, wout,
              w.data_ptr(), bias.data_ptr(), float(clamp_min),
              float(clamp_max), out.data_ptr(), _build.stream_ptr(dev))
    _build.check("fused_tail", code)
    fused_tail.launches += 1
    return out


fused_tail.launches = 0
