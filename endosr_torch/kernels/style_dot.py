"""Group style dots of the SEAN depth-matrix branch.

``style_dot_hwbm`` ports ``endosr/kernels/style_dot.py::style_dot_hwbm``
(TPU kernel ``pallas_call`` at ``:111``, twin ``style_dot_reference`` at
``:48``): out[h,w,b,m] = Σ_j shifted[b,h,w,j]·v[b,j,m], fp32 accumulation,
one rounding to the storage type. It serves the masked (bucketed) forward,
where the blend below cannot run. [H,W,B,M] is only the index order of the
returned view: the bytes are a BHWC tensor, so per-instance channel slices
are BHWC views.

``style_blend_dot`` ports ``style_blend_dot`` of the same file (TPU kernel
``pallas_call`` at ``:284``, twin ``style_blend_reference`` at ``:197``):

    out[h,w,b,m] = (Σ_j shifted[b,h,w,j]·v[b,j,m]) + concat(convs)[h,w,b,m] + bias[m]

The CUDA kernel (``endosr_torch/csrc/style_dot.cu``) tiles 64 pixels of
one image × 64 output channels, computes the K=90 dot in fp32, rounds it to
the storage type and adds the conv slice and the bias in its epilogue. The
N conv outputs are read in place through a device table of pointers, so
no concatenated copy (≈470 MB per flagship launch) is made. It is bound by
memory (≈0.96 GB per M=1792 launch, ≈0.29 ms at 3.35 TB/s). The
``hwbc`` variant of the TPU kernel is off by default there and not ported.
Both functions share the kernel's dot loop; they differ in its epilogue.
"""

from __future__ import annotations

import torch

from endosr_torch.kernels import _build

__all__ = ["style_blend_dot", "style_blend_plain", "style_dot_hwbm",
           "style_dot_plain"]


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


def style_dot_plain(shifted, v):
    """Plain PyTorch version: [B,H,W,J] × [B,J,M] → [H,W,B,M]."""
    return torch.einsum("bhwj,bjm->bhwm", shifted, v).permute(1, 2, 0, 3)


def style_dot_hwbm(shifted, v):
    """Group style dot [B,H,W,J] × [B,J,M] → [H, W, B, M] (the HWNC view
    of a BHWC tensor), any B and M.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot)."""
    if shifted.device.type == "cpu":
        return style_dot_plain(shifted, v)
    fn = _build.load("style_dot", "style_dot_hwbm")
    b, h, w, j = shifted.shape
    if v.shape[:2] != (b, j):
        raise ValueError(f"v must be [{b},{j},M], got {tuple(v.shape)}")
    if v.dtype != shifted.dtype:
        raise TypeError("shifted and v must share one dtype")
    m = v.shape[2]
    dt, dev = shifted.dtype, shifted.device
    sh = shifted.contiguous()
    vv = v.contiguous()
    out = torch.empty((b, h, w, m), dtype=dt, device=dev)
    code = fn(_build.dtype_code(dt), sh.data_ptr(), vv.data_ptr(),
              out.data_ptr(), out.stride(1), out.stride(2), out.stride(0),
              b, h, w, j, m, _build.stream_ptr(dev))
    _build.check("style_dot", code, "style_dot_hwbm")
    style_dot_hwbm.launches += 1
    return out.permute(1, 2, 0, 3)


style_dot_hwbm.launches = 0
