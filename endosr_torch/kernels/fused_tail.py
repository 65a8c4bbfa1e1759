"""Fused ×8 tail head: folded head conv → clamp → PixelShuffle(4) → fp32 rows.

Port of ``endosr/kernels/fused_tail.py::fused_tail`` (TPU kernel
``pallas_call`` at ``:238``, twin ``fused_tail_reference`` at ``:94``). From
the packed tail's last tensor g4 (activated and gated, with zero columns
beyond ``wout``; or raw, with the producer's deferred ``pre_bias``):

    a = g4, or gate(leaky_relu(g4 + pre_bias))     (row ≥ h, column ≥ wout dead)
    pre[b,y,x,o] = Σ_{dy,dx,c} a[b, y+dy−1, x+dx−1, c] · wh[dy,dx,c,o] + bh[o]
    out[b, 4y+i, (4x+j)·3 + c] = float(clamp(pre[b,y,x, c·16 + i·4 + j]))

for y < h = Hp−1, x < wout, zero padding above and left. It is bound by
operations (2·B·h·wout·9·C4·48 ≈ 232 GFLOP at the flagship shape, 0.23 ms
at the H100's bf16 tensor-core peak; the bytes, g4 once and the image once,
are close behind). ``endosr_torch/csrc/fused_tail.cu`` holds two
hand-written kernels and :func:`fused_tail_route` picks one by shape, never
by trial:

- ``"wgmma"``: bf16, C4 a multiple of 64, g4's strides multiples of 8
  elements and its base 16-byte aligned. The implicit GEMM on ``wgmma`` of
  ``csrc/conv3x3_wgmma.cuh`` (``head_dot``'s: TMA halo tiles activated in
  place, so the raw g4 is read once) with N = 48 and the output stage as
  its epilogue: a warp stages its 16 pixels × 48 clamped fp32 values in
  shared memory in output-row order and writes them as 16-byte pieces. The
  weights stream as swizzled 48 × 64 tiles that
  :func:`fused_tail_pack_weights` arranges once per call.
- ``"mma"``: any other bf16 shape, the shared warp-``mma`` implicit GEMM
  with the output stage as its per-element epilogue.
- ``"fp32"``: float32 storage, the exact fp32 loop on the CUDA cores.

Both reorder the 48 output channels to i·12 + j·3 + c, so one pixel's
twelve values of an output row are neighbours, and neither ``pre`` nor an
embedded 64-channel copy reaches device memory. The TPU kernel is
square-only and needs its column count aligned; these take any h, wout.
Its strip DMA, tap-stacked lanes and one-hot scatter are not copied.
``fused_tail.launches`` counts launches, ``fused_tail.routes`` counts them
per route.
"""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.kernels import _build
from endosr_torch.kernels._autograd import differentiable, twin_vjp
from endosr_torch.kernels.head_dot import wgmma_pack_index
from endosr_torch.kernels.output_stage import output_stage_plain
from endosr_torch.nn.layers import conv2d_nhwc, leaky_relu
from endosr_torch.utils.device import device_constant
from endosr_torch.utils.prof import annotate

__all__ = ["fused_tail", "fused_tail_plain", "fused_tail_route",
           "fused_tail_vjp",
           "fused_tail_pack_weights", "fused_tail_unpack_weights",
           "launch_igemm", "launch_wgmma"]


def _row_major_channels() -> np.ndarray:
    """[48]: the canonical PS(4) channel c·16 + i·4 + j at slot i·12 + j·3 + c."""
    m = np.arange(48)
    i, j, c = m // 12, (m % 12) // 3, m % 3
    return c * 16 + i * 4 + j


def fused_tail_plain(g4, wh, bh, clamp_min=0.0, clamp_max=1.0, layout="bhwc",
                     wout=None, pre_bias=None):
    """Plain PyTorch version: optional producer epilogue (bias +
    leaky_relu(0.2) and the s=0 gate: row Hp−1 and columns ≥ ``wout``
    dead), head conv (pad (1,0),(1,0)) cropped to ``wout`` columns + bias →
    clamp → PixelShuffle(4) → fp32 [B, 4·(Hp−1), 12·wout]."""
    if layout == "hwbc":
        g4 = g4.permute(2, 0, 1, 3)
    dt = g4.dtype
    hp, wc = g4.shape[1], g4.shape[2]
    wout = hp - 1 if wout is None else wout
    if pre_bias is not None:
        dev = g4.device
        mr = (torch.arange(hp, device=dev) < hp - 1).to(dt)
        mc = (torch.arange(wc, device=dev) < wout).to(dt)
        g4 = (leaky_relu(g4 + pre_bias.to(dt)) * mr[None, :, None, None]
              * mc[None, None, :, None])
    pre = conv2d_nhwc(g4, wh, ((1, 0), (1, 0)), dt)[:, :, :wout] + bh.to(dt)
    return output_stage_plain(pre, 4, clamp_min, clamp_max)


def _strides(g4, layout):
    """g4's (row, column, batch, channel) element strides."""
    st = g4.stride()
    return st if layout == "hwbc" else (st[1], st[2], st[0], st[3])


def fused_tail_route(dtype, c4, strides, data_ptr):
    """Which kernel a CUDA call takes: ``"wgmma"``, ``"mma"`` or ``"fp32"``.
    ``strides``: g4's element strides (row, column, batch, channel);
    ``data_ptr``: its address."""
    if dtype == torch.float32:
        return "fp32"
    if (c4 % 64 == 0 and strides[3] == 1 and data_ptr % 16 == 0
            and all(s % 8 == 0 for s in strides[:3])):
        return "wgmma"
    return "mma"


def _tail_pack_index(c4):
    """Flat indices into the canonical head wh [3,3,C4,48] of the ``wgmma``
    order: :func:`wgmma_pack_index` over the row-major channel order."""
    idx = wgmma_pack_index(c4, 48)
    o = idx % 48
    return idx - o + _row_major_channels()[o]


def fused_tail_pack_weights(wh):
    """wh [3,3,C4,48] (canonical PS(4) output order) → [C4/64, 9, 48, 64]:
    the order the ``wgmma`` kernel streams, one [o, c] tile (o in
    i·12 + j·3 + c order, c contiguous) per 64-channel slice and tap, each
    row's 16-byte pieces swizzled. One gather."""
    c4 = wh.shape[2]
    if c4 % 64 or tuple(wh.shape) != (3, 3, c4, 48):
        raise ValueError(f"wh {tuple(wh.shape)}: needs [3,3,C4,48] with "
                         "C4 % 64 == 0")
    idx = device_constant(_tail_pack_index, (c4,), torch.int64, wh.device)
    return wh.reshape(-1)[idx].reshape(c4 // 64, 9, 48, 64)


def fused_tail_unpack_weights(packed):
    """Inverse of :func:`fused_tail_pack_weights`: → wh [3,3,C4,48]."""
    c4 = packed.shape[0] * 64
    idx = device_constant(_tail_pack_index, (c4,), torch.int64, packed.device)
    flat = torch.empty(9 * c4 * 48, dtype=packed.dtype, device=packed.device)
    flat[idx] = packed.reshape(-1)
    return flat.reshape(3, 3, c4, 48)


def _aligned(t):
    return t.clone() if t.data_ptr() % 16 else t


def _common(g4, bh, layout, wout, pre_bias):
    """(b, h, wc, c4, strides, fp32 bias in slot order, pre_bias in g4's
    dtype or None, the output buffer)."""
    st = _strides(g4, layout)
    if layout == "hwbc":
        hp, wc, b, c4 = g4.shape
    else:
        b, hp, wc, c4 = g4.shape
    dt, dev = g4.dtype, g4.device
    perm = device_constant(_row_major_channels, (), torch.int64, dev)
    bias = bh.float()[perm].contiguous()
    pb = None if pre_bias is None else _aligned(pre_bias.to(dt).contiguous())
    out = torch.empty((b, 4 * (hp - 1), 12 * wout), dtype=torch.float32, device=dev)
    return b, hp - 1, wc, c4, st, bias, pb, out


def launch_igemm(g4, wh, bh, clamp_min, clamp_max, layout, wout, pre_bias=None):
    """Launch the shared implicit GEMM (routes ``"mma"`` and ``"fp32"``) on
    CUDA operands; counts nothing."""
    fn = _build.load("fused_tail")
    b, h, _, c4, st, bias, pb, out = _common(g4, bh, layout, wout, pre_bias)
    dt = g4.dtype
    perm = device_constant(_row_major_channels, (), torch.int64, g4.device)
    w = wh.to(dt)[..., perm].contiguous()
    code = fn(_build.dtype_code(dt), g4.data_ptr(), st[0], st[1], st[2], b, c4,
              h, wout, w.data_ptr(), bias.data_ptr(),
              None if pb is None else pb.data_ptr(), float(clamp_min),
              float(clamp_max), out.data_ptr(), _build.stream_ptr(g4.device))
    _build.check("fused_tail", code)
    return out


def launch_wgmma(g4, wh, bh, clamp_min, clamp_max, layout, wout, pre_bias=None):
    """Launch the ``wgmma`` kernel (route ``"wgmma"``) on CUDA operands;
    counts nothing."""
    fn = _build.load("fused_tail", "fused_tail_wgmma")
    if g4.data_ptr() % 16:
        raise ValueError("g4 must be 16-byte aligned")
    b, h, wc, c4, st, bias, pb, out = _common(g4, bh, layout, wout, pre_bias)
    with annotate("net.prepare"):
        wp = fused_tail_pack_weights(wh.to(g4.dtype))
    code = fn(g4.data_ptr(), st[0], st[1], st[2], b, c4, h, wc, wout,
              wp.data_ptr(), bias.data_ptr(),
              None if pb is None else pb.data_ptr(), float(clamp_min),
              float(clamp_max), out.data_ptr(), _build.stream_ptr(g4.device))
    _build.check("fused_tail", code, "fused_tail_wgmma")
    return out


def fused_tail(g4, wh, bh, clamp_min=0.0, clamp_max=1.0, layout="bhwc",
               wout=None, pre_bias=None):
    """g4 [B,Hp,Wc,C4] (``layout="bhwc"``) or [Hp,Wc,B,C4] (``"hwbc"``),
    activated and gated, or raw with the producer's ``pre_bias`` [C4]; wh
    [3,3,C4,48] in canonical PS(4) output order, bh [48] → [B, 4·(Hp−1),
    12·wout] fp32 (``wout`` defaults to Hp−1; Wc > wout).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`fused_tail_route` names (and raises if it cannot).
    Under autograd the backward is :func:`fused_tail_vjp`."""
    with annotate("kernel.fused_tail"):
        return differentiable(
            lambda a, w, b, pb: _forward(a, w, b, clamp_min, clamp_max, layout,
                                         wout, pb),
            lambda saved, g: fused_tail_vjp(*saved, g, clamp_min, clamp_max,
                                            layout, wout),
            (g4, wh, bh, pre_bias))


def fused_tail_vjp(g4, wh, bh, pre_bias, g, clamp_min=0.0, clamp_max=1.0,
                   layout="bhwc", wout=None):
    """The backward of :func:`fused_tail` (the JAX ``_bwd``,
    ``fused_tail.py:271-283``): the VJP of the plain version at the saved
    inputs. Returns the gradients of (g4, wh, bh, pre_bias)."""
    with annotate("kernel.fused_tail_vjp"):
        return twin_vjp(
            lambda a, w, b, pb: fused_tail_plain(a, w, b, clamp_min, clamp_max,
                                                 layout, wout, pb),
            (g4, wh, bh, pre_bias), g)


def _forward(g4, wh, bh, clamp_min, clamp_max, layout, wout, pre_bias):
    if g4.device.type == "cpu":
        return fused_tail_plain(g4, wh, bh, clamp_min, clamp_max, layout, wout,
                                pre_bias)
    hp, wc, c4 = (g4.shape[0], g4.shape[1], g4.shape[3]) if layout == "hwbc" \
        else (g4.shape[1], g4.shape[2], g4.shape[3])
    wout = hp - 1 if wout is None else wout
    if (g4.stride(3) != 1 or c4 % 16 or wc <= wout
            or tuple(wh.shape) != (3, 3, c4, 48) or bh.numel() != 48):
        raise ValueError(
            f"g4 {tuple(g4.shape)} ({layout}) strides {g4.stride()}, wh "
            f"{tuple(wh.shape)}: channels must be contiguous and a multiple "
            "of 16, Wc > wout, and the head [3,3,C4,48]")
    route = fused_tail_route(g4.dtype, c4, _strides(g4, layout), g4.data_ptr())
    launch = launch_wgmma if route == "wgmma" else launch_igemm
    out = launch(g4, wh, bh, clamp_min, clamp_max, layout, wout, pre_bias)
    fused_tail.launches += 1
    fused_tail.routes[route] += 1
    return out


fused_tail.launches = 0
fused_tail.routes = {"wgmma": 0, "mma": 0, "fp32": 0}
