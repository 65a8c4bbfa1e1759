"""Fused style + o-branch blend for one group of SEAN instances.

Port of ``endosr/kernels/style_dot.py::style_blend_dot`` (TPU kernel
``pallas_call`` at ``:284``, twin ``style_blend_reference`` at ``:197``):

    out[h,w,b,m] = (Σ_j shifted[b,h,w,j]·v[b,j,m]) + concat(convs)[h,w,b,m] + bias[m]

The CUDA kernel (``endosr_torch/csrc/style_dot.cu``) tiles 64 pixels of
one image × 64 output channels, computes the K=90 dot in fp32, rounds it to
the storage type and adds the conv slice and the bias in its epilogue. The
N conv outputs are read in place through a device table of pointers, so
no concatenated copy (≈470 MB per flagship launch) is made. It is bound by
memory (≈0.96 GB per M=1792 launch, ≈0.29 ms at 3.35 TB/s). The
``hwbc`` variant of the TPU kernel is off by default there and not ported;
``style_dot_hwbm`` is a separate kernel still to be ported.
"""

from __future__ import annotations

import torch

from endosr_torch.kernels import _build

__all__ = ["style_blend_dot", "style_blend_plain"]


def style_blend_plain(shifted, v, convs, bias):
    """Plain PyTorch version: shifted [B,H,W,J], v [B,J,M], convs tuple of
    [H,W,B,2C] tensors with Σ2C = M, bias [M] → [H,W,B,M]."""
    dt = shifted.dtype
    y = torch.einsum("bhwj,bjm->bhwm", shifted, v).permute(1, 2, 0, 3).to(dt)
    return (y + torch.cat(list(convs), dim=-1)) + bias.to(dt)


def style_blend_dot(shifted, v, convs, bias):
    """Group style dot + conv adds + bias → [H, W, B, M] (the HWNC view of
    a BHWC tensor, so per-instance channel slices are BHWC views).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot)."""
    if shifted.device.type == "cpu":
        return style_blend_plain(shifted, v, convs, bias)
    fn = _build.load("style_dot")
    b, h, w, j = shifted.shape
    m = v.shape[2]
    n = len(convs)
    c2 = convs[0].shape[3]
    if n * c2 != m or any(c.shape != (h, w, b, c2) for c in convs):
        raise ValueError(f"convs must be {n} × [{h},{w},{b},{c2}] with "
                         f"{n}·{c2} = M = {m}")
    st = convs[0].stride()
    if st[3] != 1 or any(c.stride() != st for c in convs):
        raise ValueError("convs must share strides with contiguous channels")
    dt, dev = shifted.dtype, shifted.device
    if v.dtype != dt or any(c.dtype != dt for c in convs):
        raise TypeError("shifted, v and convs must share one dtype")
    sh = shifted.contiguous()
    vv = v.contiguous()
    bias32 = bias.float().contiguous()
    # pinned + non_blocking: the host does not wait for the device's queue
    table = torch.tensor([c.data_ptr() for c in convs],
                         dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    out = torch.empty((b, h, w, m), dtype=dt, device=dev)
    code = fn(_build.dtype_code(dt), sh.data_ptr(), vv.data_ptr(),
              table.data_ptr(), st[0], st[1], st[2], c2, bias32.data_ptr(),
              out.data_ptr(), out.stride(1), out.stride(2), out.stride(0),
              b, h, w, j, m, _build.stream_ptr(dev))
    _build.check("style_dot", code)
    style_blend_dot.launches += 1
    return out.permute(1, 2, 0, 3)


style_blend_dot.launches = 0
