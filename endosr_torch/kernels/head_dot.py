"""Folded ×8 head conv of the packed tail (``g4 ⊛ w64 → pre64``).

Port of ``endosr/kernels/head_dot.py::head_dot`` (TPU kernel
``pallas_call`` at ``:283``, twin ``head_dot_reference`` at ``:96``). The
CUDA kernel is ``endosr_torch/csrc/head_dot.cu``: a direct 3×3 conv as an
implicit GEMM over (output pixel × 64 channels) tiles that applies the
producer's bias + leaky_relu and the s=0 dead row/column gate while it
loads g4, accumulates in fp32 and writes HBWC. It is bound by operations
(≈309 GFLOP at the flagship shape, ≈0.31 ms of bf16 tensor-core time);
bf16 runs on the tensor cores through warp-level mma, fp32 on the CUDA
cores. The TPU kernel's nine-tap lane stacking is not copied.
"""

from __future__ import annotations

import torch

from endosr_torch.kernels import _build
from endosr_torch.nn.layers import conv2d_nhwc, leaky_relu

__all__ = ["head_dot", "head_dot_plain"]


def head_dot_plain(g4_hwnc, w64, b64, wout=None, pre_bias=None):
    """Plain PyTorch version: optional producer epilogue (bias +
    leaky_relu(0.2)),
    the s=0 edge gate (row ≥ h, column ≥ wout dead), conv pad (1,0) + bias
    on the BHWC view; returns [h, B, wout, Cout] (HBWC)."""
    dt = g4_hwnc.dtype
    if pre_bias is not None:
        g4_hwnc = leaky_relu(g4_hwnc + pre_bias.to(dt))
    g4 = g4_hwnc.permute(2, 0, 1, 3)
    hp, wc = g4.shape[1], g4.shape[2]
    h = hp - 1
    wout = h if wout is None else wout
    dev = g4.device
    mr = (torch.arange(hp, device=dev) < h).to(dt)
    mc = (torch.arange(wc, device=dev) < wout).to(dt)
    g4 = g4 * mr[None, :, None, None] * mc[None, None, :, None]
    pre = conv2d_nhwc(g4, w64, ((1, 0), (1, 0)), dt)[:, :, :wout] + b64.to(dt)
    return pre.permute(1, 0, 2, 3)


def head_dot(g4_hwnc, w64, b64, wout=None, pre_bias=None):
    """Head conv from an HWNC g4 [Hp, Wc, B, C4] (ungated; raw producer
    output when ``pre_bias`` is given) with w64 [3,3,C4,Cout], b64 [Cout]
    → [Hp−1, B, wout, Cout] (HBWC).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot)."""
    if g4_hwnc.device.type == "cpu":
        return head_dot_plain(g4_hwnc, w64, b64, wout, pre_bias)
    fn = _build.load("head_dot")
    hp, wc, b, c4 = g4_hwnc.shape
    h = hp - 1
    wout = h if wout is None else wout
    cout = w64.shape[3]
    if g4_hwnc.stride(3) != 1 or c4 % 16 or wc < wout:
        raise ValueError(f"g4 {tuple(g4_hwnc.shape)} strides "
                         f"{g4_hwnc.stride()}: channels must be contiguous, "
                         "a multiple of 16, and Wc ≥ wout")
    dt = g4_hwnc.dtype
    w = w64.to(dt).contiguous()
    bias = b64.float().contiguous()
    pb = None if pre_bias is None else pre_bias.to(dt).contiguous()
    out = torch.empty((h, b, wout, cout), dtype=dt, device=g4_hwnc.device)
    code = fn(_build.dtype_code(dt), g4_hwnc.data_ptr(), g4_hwnc.stride(0),
              g4_hwnc.stride(1), g4_hwnc.stride(2), b, c4, h, wout,
              w.data_ptr(), bias.data_ptr(),
              None if pb is None else pb.data_ptr(), out.data_ptr(), cout,
              _build.stream_ptr(g4_hwnc.device))
    _build.check("head_dot", code)
    head_dot.launches += 1
    return out


head_dot.launches = 0
