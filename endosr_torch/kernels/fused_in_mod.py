"""Fused InstanceNorm + SEAN modulation: out = IN(x)·(1 + γ) + β.

Port of ``endosr/kernels/fused_in_mod.py::fused_instance_norm_modulate``
(TPU kernel ``pallas_call`` at ``:95``, twin
``instance_norm_modulate_reference`` at ``:36``), inference only. The CUDA
code (``endosr_torch/csrc/fused_in_mod.cu``) takes the statistics as the
TPU kernel's body does (fp32 Σx and Σx², var = E[x²] − μ², clamped at 0)
with the two-stage reduction of ``in_stats.cuh``, then applies
((x − μ)·rsqrt(var + ε))·(1 + γ) + β in fp32 with γ and β read in x's
type, and stores x's type. It is bound by memory (x, γ, β in, out once);
this version reads x twice. There is no fallback to the plain version on
a CUDA tensor.
"""

from __future__ import annotations

import torch

from endosr_torch.kernels import _build
from endosr_torch.kernels.in_stats import stats_chunks

__all__ = ["fused_in_mod", "fused_in_mod_plain"]


def fused_in_mod_plain(x, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch version (two-pass variance, as the twin)."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    normalized = (x32 - mean) * torch.rsqrt(var + eps)
    return (normalized * (1.0 + gamma.to(x.dtype).float())
            + beta.to(x.dtype).float()).to(x.dtype)


def fused_in_mod(x, gamma, beta, eps: float = 1e-5):
    """IN(x)·(1+γ)+β for NHWC ``x`` and same-shape γ, β → x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot)."""
    if x.device.type == "cpu":
        return fused_in_mod_plain(x, gamma, beta, eps)
    fn = _build.load("fused_in_mod")
    b, h, w, c = x.shape
    if gamma.shape != x.shape or beta.shape != x.shape:
        raise ValueError(f"γ {tuple(gamma.shape)} and β {tuple(beta.shape)} "
                         f"must have x's shape {tuple(x.shape)}")
    gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
    if any(t.stride(-1) != 1 for t in (x, gamma, beta)):
        raise ValueError("x, γ and β must have contiguous channels")
    chunks = stats_chunks(h * w)
    dev = x.device
    part = torch.empty((b, chunks, c, 2), dtype=torch.float32, device=dev)
    stats = torch.empty((b, c, 2), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, w, c), dtype=x.dtype, device=dev)
    code = fn(_build.dtype_code(x.dtype),
              x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
              gamma.data_ptr(), gamma.stride(0), gamma.stride(1),
              gamma.stride(2),
              beta.data_ptr(), beta.stride(0), beta.stride(1), beta.stride(2),
              b, h, w, c, chunks, float(eps), part.data_ptr(),
              stats.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
    _build.check("fused_in_mod", code)
    fused_in_mod.launches += 1
    return out


fused_in_mod.launches = 0
