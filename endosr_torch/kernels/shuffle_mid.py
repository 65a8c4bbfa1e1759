"""PixelShuffle(r) of an NHWC tensor as one pass, with its exact adjoint.

Port of ``endosr/kernels/shuffle_mid.py::mid_shuffle`` (TPU kernel
``pallas_call`` at ``:94``; adjoint ``:114-119``):

    out[b, y·r+i, x·r+j, c] = z[b, y, x, c·r² + i·r + j]

and, for the gradient, the inverse permutation (the op is linear and its
adjoint is the un-shuffle with the same channel order). The CUDA kernels
(``endosr_torch/csrc/shuffle_mid.cu``) are pure copies of 2- or 4-byte
elements, bit-identical to the plain version, bound by bytes (the tensor
read once and written once). :func:`mid_shuffle_route` picks one by shape:

- ``"vec16"``: r = 2, C a multiple of 16 / element size, both tensors
  16-byte aligned. A thread reads the contiguous packed run of its
  channels' four phases as four 16-byte loads, transposes it in registers
  and writes one 16-byte piece to each of the four shuffled pixels (the
  adjoint the other way round).
- ``"scalar"``: any other r or C. A block owns a few pixels of one input
  row and walks the r output rows they feed element by element.

The TPU kernel's one-hot selection matmuls, its 128-channel gate and its
r = 2 gate are not copied. ``mid_shuffle.launches`` counts launches,
forward and backward, ``mid_shuffle.routes`` counts them per route.

As in the JAX package no forward calls it: it is a kernel with its exact
adjoint, held against the plain version by the tests and by
``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from endosr_torch.kernels import _build
from endosr_torch.nn.layers import pixel_shuffle
from endosr_torch.utils.prof import annotate

__all__ = ["mid_shuffle", "mid_shuffle_plain", "mid_shuffle_route",
           "mid_unshuffle_plain", "launch"]


def mid_shuffle_plain(z, r):
    """Plain PyTorch version: [B,H,W,C·r²] → [B,H·r,W·r,C], contiguous."""
    return pixel_shuffle(z, r).contiguous()


def mid_unshuffle_plain(g, r):
    """The adjoint (and inverse): [B,H·r,W·r,C] → [B,H,W,C·r²]."""
    b, hr, wr, c = g.shape
    h, w = hr // r, wr // r
    gz = g.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)
    return gz.reshape(b, h, w, c * r * r)


def mid_shuffle_route(esize, r, c, ptrs):
    """Which kernel a CUDA call takes: ``"vec16"`` or ``"scalar"``.
    ``esize``: bytes an element; ``c``: the shuffled side's channels;
    ``ptrs``: the base addresses of both tensors."""
    if r == 2 and c % (16 // esize) == 0 and all(p % 16 == 0 for p in ptrs):
        return "vec16"
    return "scalar"


def launch(src, r, inverse, route=None):
    """Shuffle (``src`` [B,H,W,C·r²]) or un-shuffle (``src`` [B,H·r,W·r,C])
    on the card, through the kernel ``route`` names (default: the one
    :func:`mid_shuffle_route` picks); counts nothing. Returns (output,
    route)."""
    _build.load("shuffle_mid")
    if src.element_size() not in (2, 4):
        raise TypeError(f"mid_shuffle takes 2- or 4-byte elements, got "
                        f"{src.dtype}")
    src = src.contiguous()
    if inverse:
        b, hr, wr, c = src.shape
        h, w = hr // r, wr // r
        if h * r != hr or w * r != wr:
            raise ValueError(f"{tuple(src.shape)} is not a PixelShuffle({r}) "
                             "output")
        out = torch.empty((b, h, w, c * r * r), dtype=src.dtype,
                          device=src.device)
    else:
        b, h, w, crr = src.shape
        c = crr // (r * r)
        if c * r * r != crr:
            raise ValueError(f"{crr} channels are not C·r² for r = {r}")
        out = torch.empty((b, h * r, w * r, c), dtype=src.dtype,
                          device=src.device)
    route = route or mid_shuffle_route(src.element_size(), r, c,
                                       (src.data_ptr(), out.data_ptr()))
    stream = _build.stream_ptr(src.device)
    if route == "vec16":
        fn = _build.load("shuffle_mid", "mid_shuffle_vec16")
        code = fn(src.element_size(), src.data_ptr(), out.data_ptr(), b, h, w,
                  c, int(inverse), stream)
        _build.check("shuffle_mid", code, "mid_shuffle_vec16")
    else:
        if h > 65535 or b > 65535:
            raise ValueError(f"mid_shuffle takes H, B ≤ 65535, got {h}, {b}")
        code = _build.load("shuffle_mid")(src.element_size(), src.data_ptr(),
                                          out.data_ptr(), b, h, w, c, r,
                                          int(inverse), stream)
        _build.check("shuffle_mid", code)
    return out, route


def _launch(src, r, inverse):
    out, route = launch(src, r, inverse)
    mid_shuffle.launches += 1
    mid_shuffle.routes[route] += 1
    return out


class _MidShuffle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, r):
        ctx.r = r
        return _launch(z, r, False)

    @staticmethod
    def backward(ctx, g):
        return _launch(g, ctx.r, True), None


def mid_shuffle(z, r=2):
    """PixelShuffle(r) of NHWC ``z``; differentiable, the backward being
    the un-shuffle kernel.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`mid_shuffle_route` names (and raises if it cannot).
    Forward and backward launches both count."""
    with annotate("kernel.mid_shuffle"):
        if z.device.type == "cpu":
            return mid_shuffle_plain(z, r)
        return _MidShuffle.apply(z, r)


mid_shuffle.launches = 0
mid_shuffle.routes = {"vec16": 0, "scalar": 0}
