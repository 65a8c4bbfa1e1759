"""Output stages: clamp → PixelShuffle(r) → fp32 rows.

Port of ``endosr/kernels/output_stage.py``: ``output_stage_x8`` (TPU kernel
``pallas_call`` at ``:275``, twin ``:186``) with ``embed_head_channels``
(``:166``), and the general ``output_stage`` for any r and C (``pallas_call``
at ``:316`` and ``:351``, twin ``:37``). The CUDA kernels are in
``endosr_torch/csrc/output_stage.cu``: pure gathers with a clamp and a
cast, bound by memory (~67 MB in + ~101 MB out at the ×8 flagship shape,
≈50 µs at 3.35 TB/s). ``output_stage_x8`` moves one run of twelve
contiguous channels into twelve contiguous output floats per thread;
``output_stage`` writes one output float per thread, a block walking the r
output rows one input row segment feeds. Neither copies the TPU kernels'
one-hot selection and scatter matmuls: the 64-slot embedding is kept only
as the tensor order the head conv hands over.
"""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.kernels import _build
from endosr_torch.nn.layers import pixel_shuffle
from endosr_torch.utils.device import device_constant

__all__ = ["output_stage", "output_stage_plain", "output_stage_x8",
           "output_stage_x8_plain", "embed_head_channels"]

_CP = 16  # padded per-phase channel group of the 64-slot embedding


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
    out = pixel_shuffle(torch.clamp(pre, clamp_min, clamp_max), 4)
    b, hh, ww, c = out.shape
    return out.float().reshape(b, hh, ww * c)


def output_stage_x8(pre64, clamp_min=0.0, clamp_max=1.0, order="bhwc"):
    """clip → PS(4) → fp32 from the 64-slot embedded head output
    ([B,H,W,64], or [H,B,W,64] with ``order="hbwc"``) → [B, 4H, 12W].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot)."""
    if pre64.device.type == "cpu":
        return output_stage_x8_plain(pre64, clamp_min, clamp_max, order)
    fn = _build.load("output_stage")
    if pre64.shape[-1] != 64 or pre64.stride(-1) != 1:
        raise ValueError(f"pre64 must end in 64 contiguous channels, got "
                         f"shape {tuple(pre64.shape)} strides {pre64.stride()}")
    if order == "hbwc":
        h, b, w, _ = pre64.shape
        sy, sb, sx = pre64.stride(0), pre64.stride(1), pre64.stride(2)
    else:
        b, h, w, _ = pre64.shape
        sb, sy, sx = pre64.stride(0), pre64.stride(1), pre64.stride(2)
    out = torch.empty((b, 4 * h, 12 * w), dtype=torch.float32,
                      device=pre64.device)
    code = fn(_build.dtype_code(pre64.dtype), pre64.data_ptr(), sy, sb, sx,
              h, b, w, float(clamp_min), float(clamp_max), out.data_ptr(),
              _build.stream_ptr(pre64.device))
    _build.check("output_stage", code)
    output_stage_x8.launches += 1
    return out


output_stage_x8.launches = 0


def output_stage_plain(pre, r, clamp_min=0.0, clamp_max=1.0):
    """Plain PyTorch version: clamp → PixelShuffle(r) → fp32, flattened to
    [B, H·r, W·r·C]."""
    out = pixel_shuffle(torch.clamp(pre, clamp_min, clamp_max), r)
    b, hh, ww, c = out.shape
    return out.float().reshape(b, hh, ww * c)


def output_stage(pre, r, clamp_min=0.0, clamp_max=1.0):
    """clip → PS(r) → fp32 of ``pre`` [B,H,W,C·r²] → [B, H·r, W·r·C].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot)."""
    b, h, w, crr = pre.shape
    c = crr // (r * r)
    if c * r * r != crr:
        raise ValueError(f"{crr} channels are not C·r² for r = {r}")
    if pre.device.type == "cpu":
        return output_stage_plain(pre, r, clamp_min, clamp_max)
    fn = _build.load("output_stage", "output_stage")
    if pre.stride(-1) != 1:
        raise ValueError(f"pre must have contiguous channels, got strides "
                         f"{pre.stride()}")
    if h > 65535 or b > 65535:
        raise ValueError(f"output_stage takes H, B ≤ 65535, got {h}, {b}")
    out = torch.empty((b, h * r, w * r * c), dtype=torch.float32,
                      device=pre.device)
    code = fn(_build.dtype_code(pre.dtype), pre.data_ptr(), pre.stride(0),
              pre.stride(1), pre.stride(2), b, h, w, r, c, float(clamp_min),
              float(clamp_max), out.data_ptr(), _build.stream_ptr(pre.device))
    _build.check("output_stage", code, "output_stage")
    output_stage.launches += 1
    return out


output_stage.launches = 0
