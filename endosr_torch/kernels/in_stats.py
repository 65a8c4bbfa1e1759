"""One-pass InstanceNorm statistics: fp32 (Σx, Σx²) per (b, c) over H·W.

Port of ``endosr/kernels/in_stats.py::in_stats_pallas`` (TPU kernel
``pallas_call`` at ``:47``; the jnp sums at ``:45-46`` are its twin). The
CUDA kernel (``endosr_torch/csrc/in_stats.cu`` over ``in_stats.cuh``) reads
x once and reduces in two stages, per-chunk partial sums and then their
sum in a fixed order, with no atomics: a result is bit-stable from run to
run, and differs from the plain version's only by summation order. It is
bound by memory (x read once).
"""

from __future__ import annotations

import torch

from endosr_torch.kernels import _build

__all__ = ["in_stats", "in_stats_plain", "stats_chunks"]


def stats_chunks(hw: int) -> int:
    """Pixel chunks of the first reduction stage: about 256 pixels each,
    at most 256 chunks."""
    return max(1, min(256, hw // 256))


def in_stats_plain(x):
    """Plain PyTorch version: (Σx, Σx²) over H, W of NHWC ``x`` → two
    [B, C] fp32 tensors."""
    x32 = x.float()
    return x32.sum(dim=(1, 2)), (x32 * x32).sum(dim=(1, 2))


def in_stats(x):
    """(Σx, Σx²) over the spatial dims of NHWC ``x`` → two [B, C] fp32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot)."""
    if x.device.type == "cpu":
        return in_stats_plain(x)
    fn = _build.load("in_stats")
    b, h, w, c = x.shape
    if x.stride(-1) != 1:
        raise ValueError(f"x must have contiguous channels, got strides "
                         f"{x.stride()}")
    chunks = stats_chunks(h * w)
    part = torch.empty((b, chunks, c, 2), dtype=torch.float32, device=x.device)
    out = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    code = fn(_build.dtype_code(x.dtype), x.data_ptr(), x.stride(0),
              x.stride(1), x.stride(2), b, h, w, c, chunks, part.data_ptr(),
              out.data_ptr(), _build.stream_ptr(x.device))
    _build.check("in_stats", code)
    in_stats.launches += 1
    return out[..., 0], out[..., 1]


in_stats.launches = 0
