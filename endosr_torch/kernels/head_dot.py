"""Folded ×8 head conv of the packed tail (``g4 ⊛ w64 → pre64``).

Port of ``endosr/kernels/head_dot.py::head_dot`` (TPU kernel
``pallas_call`` at ``:283``, twin ``head_dot_reference`` at ``:96``): a 3×3
conv 4C → 64 that applies the producer's bias + leaky_relu and the s=0 dead
row/column gate while it loads g4, accumulates in fp32, rounds once and
writes HBWC. It is bound by operations (≈309 GFLOP at the flagship shape,
≈0.31 ms at the H100's bf16 tensor-core peak).

``endosr_torch/csrc/head_dot.cu`` holds two hand-written kernels and
:func:`head_dot_route` picks one by shape, never by trial:

- ``"wgmma"``: bf16, C4 a multiple of 64, 64 output channels, g4's strides
  multiples of 16 bytes. The implicit GEMM on ``wgmma`` of
  ``csrc/conv3x3_wgmma.cuh`` (shared with ``fused_tail``), whose blocks
  stage a halo tile of raw g4 per 64-channel slice with one TMA load,
  activate it in place once, and take the nine taps as shifted windows of
  it (A from registers through ``ldmatrix``); the weights stream as
  swizzled 64 × 64 tiles that :func:`head_dot_pack_weights` arranges once
  per call. Its epilogue writes bf16 HBWC in 16-byte stores.
- ``"mma"``: any other bf16 shape, the shared warp-``mma`` implicit GEMM.
- ``"fp32"``: float32 storage, an exact fp32 loop on the CUDA cores.

``head_dot.launches`` counts launches, ``head_dot.routes`` counts them per
route. The TPU kernel's nine-tap lane stacking is not copied.
"""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.kernels import _build
from endosr_torch.kernels._autograd import differentiable, twin_vjp
from endosr_torch.nn.layers import conv2d_nhwc, leaky_relu
from endosr_torch.utils.device import device_constant
from endosr_torch.utils.prof import annotate

__all__ = ["head_dot", "head_dot_plain", "head_dot_route",
           "head_dot_pack_weights", "head_dot_unpack_weights",
           "head_dot_vjp", "launch_igemm",
           "launch_wgmma", "wgmma_pack_index"]

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


def head_dot_route(dtype, c4, cout, strides):
    """Which kernel a CUDA call takes: ``"wgmma"``, ``"mma"`` or ``"fp32"``.
    ``strides``: g4's element strides (row, column, batch, channel)."""
    if dtype == torch.float32:
        return "fp32"
    if (c4 % 64 == 0 and cout == 64 and strides[3] == 1
            and all(s % 8 == 0 for s in strides[:3])):
        return "wgmma"
    return "mma"


def wgmma_pack_index(c4, cout=64):
    """Flat indices into w [3,3,C4,cout] of the order the ``wgmma`` conv
    streams, [C4/64, 9 taps, cout o, 8 pieces, 8]: the piece stored at
    position j of row o is the logical piece j ^ (o & 7) (the 128-byte
    shared-memory swizzle)."""
    s, t, o, j, q = np.meshgrid(np.arange(c4 // 64), np.arange(9), np.arange(cout),
                                np.arange(8), np.arange(8), indexing="ij")
    c = s * 64 + (j ^ (o & 7)) * 8 + q
    return ((t * c4 + c) * cout + o).reshape(-1)


def head_dot_pack_weights(w64):
    """w64 [3,3,C4,64] → [C4/64, 9, 64, 64]: the order the wgmma kernel
    streams, one [o, c] tile (c contiguous) per 64-channel slice and tap,
    each row's 16-byte pieces swizzled. One gather."""
    c4, cout = w64.shape[2], w64.shape[3]
    if c4 % 64 or cout != 64:
        raise ValueError(f"w64 {tuple(w64.shape)}: needs C4 % 64 == 0 and "
                         "64 output channels")
    idx = device_constant(wgmma_pack_index, (c4,), torch.int64, w64.device)
    return w64.reshape(-1)[idx].reshape(c4 // 64, 9, 64, 64)


def head_dot_unpack_weights(packed):
    """Inverse of :func:`head_dot_pack_weights`: → w64 [3,3,C4,64]."""
    c4 = packed.shape[0] * 64
    idx = device_constant(wgmma_pack_index, (c4,), torch.int64, packed.device)
    flat = torch.empty(9 * c4 * 64, dtype=packed.dtype, device=packed.device)
    flat[idx] = packed.reshape(-1)
    return flat.reshape(3, 3, c4, 64)


def launch_igemm(g4_hwnc, w64, b64, wout, pre_bias):
    """Launch the shared implicit GEMM (routes ``"mma"`` and ``"fp32"``) on
    CUDA operands; counts nothing."""
    fn = _build.load("head_dot")
    hp, _, b, c4 = g4_hwnc.shape
    h, cout, dt = hp - 1, w64.shape[3], g4_hwnc.dtype
    if c4 % 16:
        raise ValueError(f"g4 {tuple(g4_hwnc.shape)}: channels must be a "
                         "multiple of 16")
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
    return out


def launch_wgmma(g4_hwnc, w64, b64, wout, pre_bias):
    """Launch the wgmma kernel (route ``"wgmma"``) on CUDA operands; counts
    nothing."""
    fn = _build.load("head_dot", "head_dot_wgmma")
    hp, wc, b, c4 = g4_hwnc.shape
    h, dt = hp - 1, g4_hwnc.dtype
    if g4_hwnc.data_ptr() % 16:
        raise ValueError("g4 must be 16-byte aligned")
    with annotate("net.prepare"):
        wp = head_dot_pack_weights(w64.to(dt))
    bias = b64.float().contiguous()
    pb = None if pre_bias is None else pre_bias.to(dt).contiguous()
    out = torch.empty((h, b, wout, 64), dtype=dt, device=g4_hwnc.device)
    code = fn(g4_hwnc.data_ptr(), g4_hwnc.stride(0), g4_hwnc.stride(1),
              g4_hwnc.stride(2), b, c4, h, wc, wout, wp.data_ptr(),
              bias.data_ptr(), None if pb is None else pb.data_ptr(),
              out.data_ptr(), _build.stream_ptr(g4_hwnc.device))
    _build.check("head_dot", code, "head_dot_wgmma")
    return out


def head_dot(g4_hwnc, w64, b64, wout=None, pre_bias=None):
    """Head conv from an HWNC g4 [Hp, Wc, B, C4] (ungated; raw producer
    output when ``pre_bias`` is given) with w64 [3,3,C4,Cout], b64 [Cout]
    → [Hp−1, B, wout, Cout] (HBWC).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`head_dot_route` names (and raises if it cannot). Under
    autograd the backward is :func:`head_dot_vjp`."""
    with annotate("kernel.head_dot"):
        return differentiable(
            lambda g4, w, b, pb: _forward(g4, w, b, wout, pb),
            lambda saved, g: head_dot_vjp(*saved, g, wout=wout),
            (g4_hwnc, w64, b64, pre_bias))


def head_dot_vjp(g4_hwnc, w64, b64, pre_bias, g, wout=None):
    """The backward of :func:`head_dot` (the JAX ``_bwd``,
    ``head_dot.py:310-320``): the VJP of the plain version at the saved
    inputs. Returns the gradients of (g4, w64, b64, pre_bias)."""
    with annotate("kernel.head_dot_vjp"):
        return twin_vjp(lambda a, w, b, pb: head_dot_plain(a, w, b, wout, pb),
                        (g4_hwnc, w64, b64, pre_bias), g)


def _forward(g4_hwnc, w64, b64, wout, pre_bias):
    if g4_hwnc.device.type == "cpu":
        return head_dot_plain(g4_hwnc, w64, b64, wout, pre_bias)
    hp, wc, _, c4 = g4_hwnc.shape
    wout = hp - 1 if wout is None else wout
    if g4_hwnc.stride(3) != 1 or wc < wout:
        raise ValueError(f"g4 {tuple(g4_hwnc.shape)} strides "
                         f"{g4_hwnc.stride()}: channels must be contiguous "
                         "and Wc ≥ wout")
    route = head_dot_route(g4_hwnc.dtype, c4, w64.shape[3], g4_hwnc.stride())
    launch = launch_wgmma if route == "wgmma" else launch_igemm
    out = launch(g4_hwnc, w64, b64, wout, pre_bias)
    head_dot.launches += 1
    head_dot.routes[route] += 1
    return out


head_dot.launches = 0
head_dot.routes = {"wgmma": 0, "mma": 0, "fp32": 0}
