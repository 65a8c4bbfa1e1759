"""Output stages: clamp → PixelShuffle(r) → fp32 rows.

Port of ``endosr/kernels/output_stage.py``: ``output_stage_x8`` (TPU kernel
``pallas_call`` at ``:275``, twin ``:186``) with ``embed_head_channels``
(``:166``), and the general ``output_stage`` for any r and C (``pallas_call``
at ``:316`` and ``:351``, twin ``:37``). The CUDA kernels are in
``endosr_torch/csrc/output_stage.cu``: pure gathers with a clamp and a
cast, bound by memory (~67 MB in + ~101 MB out at the ×8 flagship shape,
≈50 µs at 3.35 TB/s). The clamp bounds are rounded to the storage type
first, as ``torch.clamp`` rounds them on a bf16 tensor. A plain function
picks each kernel's route by shape:

- :func:`output_stage_x8_route` → ``"vec16"``: one thread an output float4
  (the four rows of one (y, b) are one contiguous run, stored as 512 bytes
  a warp with streaming stores) from four neighbouring channels (one 8- or
  16-byte load), four in flight a thread; for 16-byte aligned bases,
  strides that are multiples of 4 elements and H·B ≤ 65535. ``"v1"``
  otherwise: twelve scalar loads and stores a thread.
- :func:`output_stage_route` → ``"vec16"``: a block copies a span of X
  pixels of one row (contiguous, pixel stride C·r²) into shared memory
  with 16-byte copies and writes the r output rows' pieces as float4
  streaming stores; for r ∈ {2, 3, 4}, 16-byte aligned bases and row
  strides and W·r·C a multiple of 4. ``"v1"`` otherwise (a channel slice,
  an offset base): one output float a thread.

Neither copies the TPU kernels' one-hot selection and scatter matmuls: the
64-slot embedding is kept only as the tensor order the head conv hands
over. ``fn.launches`` counts launches, ``fn.routes`` counts them per route.
"""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.kernels import _build
from endosr_torch.kernels._autograd import differentiable, twin_vjp
from endosr_torch.nn.layers import clip, pixel_shuffle
from endosr_torch.utils.device import device_constant
from endosr_torch.utils.prof import annotate

__all__ = ["output_stage", "output_stage_plain", "output_stage_route",
           "output_stage_x8", "output_stage_x8_plain", "output_stage_x8_route",
           "output_stage_vjp", "output_stage_x8_vjp", "embed_head_channels",
           "launch", "launch_x8"]

_CP = 16  # padded per-phase channel group of the 64-slot embedding
SPAN_BYTES = 16384  # output_stage vec16: shared memory of a span, at most
MAX_GRID = 65535    # a grid's y and z extents


def _embed_index() -> np.ndarray:
    """[2, 48]: canonical PS(4) channel c·16+i·4+j and its embedded slot
    i·16+(j·3+c), for every (i, j, c)."""
    m = np.arange(48)
    i, j, c = m // 12, (m % 12) // 3, m % 3
    return np.stack([c * 16 + i * 4 + j, i * _CP + (j * 3 + c)])


def _unembed_index() -> np.ndarray:
    """[48]: the embedded slot of each canonical channel."""
    canon, emb = _embed_index()
    gather = np.empty(48, np.int64)
    gather[canon] = emb
    return gather


def embed_head_channels(w, b):
    """Reorder+pad a [..., 48] head conv (canonical PS(4) order c·16+i·4+j)
    to 64 channels in i·16+(j·3+c) order, zeros at slots m′ ≥ 12."""
    src, dst = device_constant(_embed_index, (), torch.int64, w.device)
    wp = torch.zeros(w.shape[:-1] + (64,), dtype=w.dtype, device=w.device)
    bp = torch.zeros((64,), dtype=b.dtype, device=b.device)
    wp[..., dst] = w[..., src]
    bp[dst] = b[src]
    return wp, bp


def output_stage_x8_plain(pre64, clamp_min=0.0, clamp_max=1.0, order="bhwc"):
    """Plain PyTorch version: un-embed, clamp, PixelShuffle(4), fp32,
    flattened to [B, 4H, 12W]."""
    if order == "hbwc":
        pre64 = pre64.permute(1, 0, 2, 3)
    pre = pre64[..., device_constant(_unembed_index, (), torch.int64,
                                     pre64.device)]
    out = pixel_shuffle(clip(pre, clamp_min, clamp_max), 4)
    b, hh, ww, c = out.shape
    return out.float().reshape(b, hh, ww * c)


def output_stage_x8_route(dtype, shape, strides, ptr):
    """Which kernel a CUDA call of :func:`output_stage_x8` takes: ``"vec16"``
    or ``"v1"``. ``shape``, ``strides``: of the [H, B, W, 64] (HBWC) view
    in elements; ``ptr``: its base address."""
    h, b, _, c = shape
    if (dtype in (torch.float32, torch.bfloat16) and c == 64
            and strides[3] == 1 and all(s % 4 == 0 for s in strides[:3])
            and ptr % 16 == 0 and h * b <= MAX_GRID):
        return "vec16"
    return "v1"


def launch_x8(pre64, clamp_min=0.0, clamp_max=1.0, order="bhwc", route=None,
              lib="output_stage"):
    """:func:`output_stage_x8` of CUDA ``pre64`` through the kernel ``route``
    names (default: the one :func:`output_stage_x8_route` picks) of library
    ``lib``; counts nothing. Returns (output, route)."""
    _build.load(lib)
    if pre64.shape[-1] != 64 or pre64.stride(-1) != 1:
        raise ValueError(f"pre64 must end in 64 contiguous channels, got "
                         f"shape {tuple(pre64.shape)} strides {pre64.stride()}")
    hbwc = pre64 if order == "hbwc" else pre64.permute(1, 0, 2, 3)
    h, b, w, _ = hbwc.shape
    route = route or output_stage_x8_route(hbwc.dtype, hbwc.shape,
                                           hbwc.stride(), hbwc.data_ptr())
    out = torch.empty((b, 4 * h, 12 * w), dtype=torch.float32,
                      device=pre64.device)
    fn_name = "output_stage_x8_vec16" if route == "vec16" else "output_stage_x8"
    code = _build.load(lib, fn_name)(
        _build.dtype_code(hbwc.dtype), hbwc.data_ptr(), *hbwc.stride()[:3],
        h, b, w, float(clamp_min), float(clamp_max), out.data_ptr(),
        _build.stream_ptr(pre64.device))
    _build.check(lib, code, fn_name)
    return out, route


def output_stage_x8(pre64, clamp_min=0.0, clamp_max=1.0, order="bhwc"):
    """clip → PS(4) → fp32 from the 64-slot embedded head output
    ([B,H,W,64], or [H,B,W,64] with ``order="hbwc"``) → [B, 4H, 12W].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`output_stage_x8_route` names (and raises if it cannot).
    Under autograd the backward is :func:`output_stage_x8_vjp`."""
    with annotate("kernel.output_stage_x8"):
        return differentiable(
            lambda p: _forward_x8(p, clamp_min, clamp_max, order),
            lambda saved, g: output_stage_x8_vjp(*saved, g, clamp_min,
                                                 clamp_max, order),
            (pre64,))


def output_stage_x8_vjp(pre64, g, clamp_min=0.0, clamp_max=1.0,
                        order="bhwc"):
    """The backward of :func:`output_stage_x8` (the JAX ``_bwd_x8``,
    ``output_stage.py:299-306``): the VJP of the plain version, g
    [B, 4H, 12W] → (g_pre64,), zero in the 16 padding slots."""
    with annotate("kernel.output_stage_x8_vjp"):
        return twin_vjp(
            lambda p: output_stage_x8_plain(p, clamp_min, clamp_max, order),
            (pre64,), g)


def _forward_x8(pre64, clamp_min, clamp_max, order):
    if pre64.device.type == "cpu":
        return output_stage_x8_plain(pre64, clamp_min, clamp_max, order)
    out, route = launch_x8(pre64, clamp_min, clamp_max, order)
    output_stage_x8.launches += 1
    output_stage_x8.routes[route] += 1
    return out


output_stage_x8.launches = 0
output_stage_x8.routes = {"vec16": 0, "v1": 0}


def output_stage_plain(pre, r, clamp_min=0.0, clamp_max=1.0):
    """Plain PyTorch version: clamp → PixelShuffle(r) → fp32, flattened to
    [B, H·r, W·r·C]."""
    out = pixel_shuffle(clip(pre, clamp_min, clamp_max), r)
    b, hh, ww, c = out.shape
    return out.float().reshape(b, hh, ww * c)


def _colours(crr, r):
    """C of a [..., C·r²] input, or raise."""
    if crr % (r * r):
        raise ValueError(f"{crr} channels are not C·r² for r = {r}")
    return crr // (r * r)


def output_stage_route(dtype, shape, r, strides, ptrs):
    """Which kernel a CUDA call of :func:`output_stage` takes: ``"vec16"``
    or ``"v1"``. ``shape``, ``strides``: of ``pre`` [B, H, W, C·r²] in
    elements; ``ptrs``: the base addresses of ``pre`` and the output."""
    b, h, w, crr = shape
    c = crr // (r * r)
    if dtype not in (torch.float32, torch.bfloat16):
        return "v1"
    v = 16 // dtype.itemsize
    sb, sy, sx, sc = strides
    if (r in (2, 3, 4) and sc == 1 and sx == crr and sb % v == 0
            and sy % v == 0 and all(p % 16 == 0 for p in ptrs)
            and w * r * c % 4 == 0 and 8 * crr * dtype.itemsize <= SPAN_BYTES
            and max(h, b) <= MAX_GRID):
        return "vec16"
    return "v1"


def launch(pre, r, clamp_min=0.0, clamp_max=1.0, route=None,
           lib="output_stage"):
    """:func:`output_stage` of CUDA ``pre`` through the kernel ``route``
    names (default: the one :func:`output_stage_route` picks) of library
    ``lib``; counts nothing. Returns (output, route)."""
    _build.load(lib)
    b, h, w, crr = pre.shape
    c = _colours(crr, r)
    if pre.stride(-1) != 1:
        raise ValueError(f"pre must have contiguous channels, got strides "
                         f"{pre.stride()}")
    if max(h, b) > MAX_GRID:
        raise ValueError(f"output_stage takes H, B ≤ {MAX_GRID}, got {h}, {b}")
    out = torch.empty((b, h * r, w * r * c), dtype=torch.float32,
                      device=pre.device)
    route = route or output_stage_route(pre.dtype, pre.shape, r, pre.stride(),
                                        (pre.data_ptr(), out.data_ptr()))
    fn_name = "output_stage_vec16" if route == "vec16" else "output_stage"
    code = _build.load(lib, fn_name)(
        _build.dtype_code(pre.dtype), pre.data_ptr(), *pre.stride()[:3], b, h,
        w, r, c, float(clamp_min), float(clamp_max), out.data_ptr(),
        _build.stream_ptr(pre.device))
    _build.check(lib, code, fn_name)
    return out, route


def output_stage(pre, r, clamp_min=0.0, clamp_max=1.0):
    """clip → PS(r) → fp32 of ``pre`` [B,H,W,C·r²] → [B, H·r, W·r·C].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`output_stage_route` names (and raises if it cannot).
    Under autograd the backward is :func:`output_stage_vjp`."""
    with annotate("kernel.output_stage"):
        _colours(pre.shape[-1], r)
        return differentiable(
            lambda p: _forward(p, r, clamp_min, clamp_max),
            lambda saved, g: output_stage_vjp(*saved, g, r, clamp_min,
                                              clamp_max),
            (pre,))


def output_stage_vjp(pre, g, r, clamp_min=0.0, clamp_max=1.0):
    """The backward of :func:`output_stage` (the JAX ``_bwd``,
    ``output_stage.py:374-380``): the VJP of the plain version, g
    [B, H·r, W·r·C] → (g_pre,)."""
    with annotate("kernel.output_stage_vjp"):
        return twin_vjp(
            lambda p: output_stage_plain(p, r, clamp_min, clamp_max), (pre,),
            g)


def _forward(pre, r, clamp_min, clamp_max):
    if pre.device.type == "cpu":
        return output_stage_plain(pre, r, clamp_min, clamp_max)
    out, route = launch(pre, r, clamp_min, clamp_max)
    output_stage.launches += 1
    output_stage.routes[route] += 1
    return out


output_stage.launches = 0
output_stage.routes = {"vec16": 0, "v1": 0}
