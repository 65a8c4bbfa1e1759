"""Fused InstanceNorm + SEAN modulation: out = IN(x)·(1 + γ) + β.

Port of ``endosr/kernels/fused_in_mod.py::fused_instance_norm_modulate``
(TPU kernel ``pallas_call`` at ``:95``, twin
``instance_norm_modulate_reference`` at ``:36``), inference only. The CUDA
code (``endosr_torch/csrc/fused_in_mod.cu``) takes the statistics as the
TPU kernel's body does (fp32 Σx and Σx², var = E[x²] − μ², clamped at 0)
with the chunked reduction of ``in_stats.cuh``, then applies
((x − μ)·rsqrt(var + ε))·(1 + γ) + β in fp32 with γ and β read in x's
type, and stores x's type. It is bound by memory (x, γ, β in, out once).
:func:`fused_in_mod_route` picks one of two routes:

- ``"vec16"``: x, γ and β each take ``in_stats``'s vec16 route and out is
  16-byte aligned. Two launches: the one-launch statistics kernel (the
  last block of an image writes μ and 1/√(var+ε)), then a pass on 16-byte
  vectors that finds x again in the L2 cache.
- ``"v1"``: anything else. Three launches (partial sums, finish, apply).

There is no fallback to the plain version on a CUDA tensor.
``fused_in_mod.launches`` counts calls, ``fused_in_mod.routes`` counts them
per route. The vec16 route shares ``in_stats``'s ticket counters.
"""

from __future__ import annotations

import torch

from endosr_torch.kernels import _build
from endosr_torch.kernels.in_stats import (MAX_B, chunk_plan,
                                           in_stats_route, tickets)

__all__ = ["fused_in_mod", "fused_in_mod_plain", "fused_in_mod_route",
           "launch"]


def fused_in_mod_plain(x, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch version (two-pass variance, as the twin)."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    normalized = (x32 - mean) * torch.rsqrt(var + eps)
    return (normalized * (1.0 + gamma.to(x.dtype).float())
            + beta.to(x.dtype).float()).to(x.dtype)


def fused_in_mod_route(dtype, c, strides, ptrs):
    """Which kernels a CUDA call takes: ``"vec16"`` or ``"v1"``.
    ``strides``: the (batch, row, column) element strides of x, γ and β;
    ``ptrs``: the base addresses of x, γ, β and out."""
    if (ptrs[3] % 16 == 0
            and all(in_stats_route(dtype, c, s, p) == "vec16"
                    for s, p in zip(strides, ptrs))):
        return "vec16"
    return "v1"


def launch(x, gamma, beta, eps=1e-5, route=None, lib="fused_in_mod",
           per=None):
    """IN(x)·(1+γ)+β of CUDA tensors through the kernels ``route`` names
    (default: the ones :func:`fused_in_mod_route` picks) of library
    ``lib``, the statistics in chunks of ``per`` pixels if given (else
    ``stats_plan``'s); counts nothing. Returns (output, route)."""
    _build.load(lib)
    b, h, w, c = x.shape
    if gamma.shape != x.shape or beta.shape != x.shape:
        raise ValueError(f"γ {tuple(gamma.shape)} and β {tuple(beta.shape)} "
                         f"must have x's shape {tuple(x.shape)}")
    gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
    if any(t.stride(-1) != 1 for t in (x, gamma, beta)):
        raise ValueError("x, γ and β must have contiguous channels")
    if b > MAX_B:
        raise ValueError(f"fused_in_mod takes B ≤ {MAX_B}, got {b}")
    dev = x.device
    out = torch.empty((b, h, w, c), dtype=x.dtype, device=dev)
    strides = tuple((t.stride(0), t.stride(1), t.stride(2))
                    for t in (x, gamma, beta))
    route = route or fused_in_mod_route(
        x.dtype, c, strides,
        (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr()))
    chunks, per = chunk_plan(b, h * w, route, per)
    part = torch.empty((b, chunks, c, 2), dtype=torch.float32, device=dev)
    stats = torch.empty((b, c, 2), dtype=torch.float32, device=dev)
    args = [_build.dtype_code(x.dtype)]
    for t, st in zip((x, gamma, beta), strides):
        args += [t.data_ptr(), *st]
    args += [b, h, w, c, chunks]
    stream = _build.stream_ptr(dev)
    if route == "vec16":
        fn = _build.load(lib, "fused_in_mod_vec16")
        code = fn(*args, per, float(eps), part.data_ptr(),
                  tickets(dev, b).data_ptr(), stats.data_ptr(), out.data_ptr(),
                  stream)
        _build.check(lib, code, "fused_in_mod_vec16")
    else:
        code = _build.load(lib)(*args, float(eps), part.data_ptr(),
                                stats.data_ptr(), out.data_ptr(), stream)
        _build.check(lib, code)
    return out, route


def fused_in_mod(x, gamma, beta, eps: float = 1e-5):
    """IN(x)·(1+γ)+β for NHWC ``x`` and same-shape γ, β → x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels :func:`fused_in_mod_route` names (and raises if it cannot)."""
    if x.device.type == "cpu":
        return fused_in_mod_plain(x, gamma, beta, eps)
    out, route = launch(x, gamma, beta, eps)
    fused_in_mod.launches += 1
    fused_in_mod.routes[route] += 1
    return out


fused_in_mod.launches = 0
fused_in_mod.routes = {"vec16": 0, "v1": 0}
