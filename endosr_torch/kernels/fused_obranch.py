"""Fused SEAN depth-map branch of N instances (conv1 → ReLU → conv2).

Port of ``endosr/kernels/fused_obranch.py::fused_o_branch`` (TPU kernel
``pallas_call`` at ``:146``, twin ``fused_o_branch_reference`` at ``:51``):

    ob[b,y,x, n·2C+c] = conv3×3(relu(conv3×3(d; wm_n) + bm_n); w2_n)[c] + b2_n[c]

with conv2's padding ring of the activation zero (not ``relu(bm)``). The
activation is computed on chip, rounded once to the storage type, and never
reaches device memory; the conv2 sum is rounded to the storage type, then
the bias is added, as the twin does. It is bound by operations
(2·B·H·W·N·9·(2C)² ≈ 1.0 TFLOP at the flagship shape).

``endosr_torch/csrc/fused_mod.cu`` (shared with ``fused_modulation``) holds
three kernels and :func:`fused_o_branch_route` picks one by shape, never
by trial:

- ``"wgmma"``: bf16, 2C = 64 or 128, 16-byte aligned operands. Persistent
  blocks walk tiles of 3 rows × 64 columns × all 2C channels of one image
  and one instance, instance-major; a producer warpgroup computes conv1 for
  each 64-channel slice of the tile's halo with one ``mma`` k-step into
  shared memory, three consumer warpgroups run conv2 as ``wgmma`` with A
  from that halo through ``ldmatrix``, and the weights stream through a
  ring of 1-D bulk copies, packed once per call by
  :func:`o_branch_pack_weights`.
- ``"mma"``: any other bf16 shape (2C = 16 or 32): a block an 8×16-pixel
  tile of one instance, warp-level ``mma``.
- ``"fp32"``: float32 storage, an exact fp32 loop on the CUDA cores.

``fused_o_branch.launches`` counts launches, ``fused_o_branch.routes``
counts them per route. The TPU kernel's pre-cut row tiles and tap stack of
the depth map, and its bf16-only gate, are not copied: any H, W and both
storage types run, for 2C = 16, 32, 64 or 128.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from endosr_torch.kernels import _build
from endosr_torch.kernels._autograd import differentiable, twin_vjp
from endosr_torch.utils.device import device_constant
from endosr_torch.utils.prof import annotate

__all__ = ["fused_o_branch", "fused_o_branch_plain", "fused_o_branch_route",
           "fused_o_branch_twin", "fused_o_branch_vjp", "promoted",
           "o_actv_plain", "acc_dtype", "grouped_w2", "check_o_operands",
           "o_branch_pack_index", "o_branch_pack_weights",
           "o_branch_unpack_weights", "launch_mma", "launch_wgmma"]


def acc_dtype(dt):
    """The type products accumulate in: fp32 for bf16 storage, else ``dt``."""
    return torch.float32 if dt == torch.bfloat16 else dt


def o_actv_plain(d, wm, bm, dt):
    """relu(conv3×3(d; wm_n) + bm_n) for all N instances → [B,H,W,N·2C] in
    ``dt``: operands rounded to ``dt``, the sum and the bias add in the
    accumulation type, one rounding after the ReLU."""
    n, _, c2 = wm.shape
    ct = acc_dtype(dt)
    w = wm.to(dt).to(ct).permute(0, 2, 1).reshape(n * c2, 1, 3, 3)
    y = F.conv2d(d.to(dt).to(ct).permute(0, 3, 1, 2), w, padding=1)
    y = torch.relu(y + bm.to(dt).to(ct).reshape(1, -1, 1, 1))
    return y.permute(0, 2, 3, 1).to(dt)


def grouped_w2(w2, n, c2):
    """[N,9,2C,2C] (tap, in, out) → the OIHW weight of an N-group conv."""
    return (w2.reshape(n, 3, 3, c2, c2).permute(0, 4, 3, 1, 2)
            .reshape(n * c2, c2, 3, 3))


def fused_o_branch_plain(d, wm, bm, w2, b2, out_dtype=None):
    """Plain PyTorch version. d [B,H,W,1]; wm [N,9,2C]; bm [N,2C]; w2
    [N,9,2C,2C]; b2 [N,2C] → [B,H,W,N·2C], instance-major channels."""
    n, _, c2 = wm.shape
    dt = out_dtype or d.dtype
    actv = o_actv_plain(d, wm, bm, dt)
    ob = F.conv2d(actv.permute(0, 3, 1, 2), grouped_w2(w2.to(dt), n, c2),
                  padding=1, groups=n)
    return ob.permute(0, 2, 3, 1) + b2.to(dt).reshape(-1)


def promoted(a, b):
    """``a`` and ``b`` in their promoted type, as a jnp op between them
    computes."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t), b.to(t)


def conv1_twin(d, wm, bm):
    """relu(conv3×3(d; wm_n) + bm_n) of all N instances → [B,N·2C,H,W]
    (NCHW) in the JAX twin's types: the conv in d and wm's promoted type,
    the bias add in that and bm's."""
    n, _, c2 = wm.shape
    d_, w_ = promoted(d, wm)
    c1 = F.conv2d(d_.permute(0, 3, 1, 2),
                  w_.permute(0, 2, 1).reshape(n * c2, 1, 3, 3), padding=1)
    c1, b_ = promoted(c1, bm)
    return torch.relu(c1 + b_.reshape(1, -1, 1, 1))


def fused_o_branch_twin(d, wm, bm, w2, b2, out_dtype=None):
    """The JAX twin's op order (``fused_obranch.py:51``), lowered as convs:
    conv1 + bias + ReLU in the operands' promoted types, rounded to the
    output type; conv2 in the promoted type, plus the bias, rounded again.
    In fp32 it is :func:`fused_o_branch_plain`; in bf16 it rounds where the
    twin does, which the plain version (as the kernel) does not."""
    n, _, c2 = wm.shape
    dt = out_dtype or d.dtype
    actv = conv1_twin(d, wm, bm).to(dt)
    a_, w_ = promoted(actv, w2)
    ob, b_ = promoted(F.conv2d(a_, grouped_w2(w_, n, c2), padding=1,
                               groups=n), b2)
    return (ob + b_.reshape(1, -1, 1, 1)).permute(0, 2, 3, 1).to(dt)


def fused_o_branch_vjp(d, wm, bm, w2, b2, g, out_dtype=None):
    """The backward of :func:`fused_o_branch` (the JAX ``_bwd``,
    ``fused_obranch.py:179-185``): the VJP of the twin
    (:func:`fused_o_branch_twin`). Returns the gradients of (d, wm, bm,
    w2, b2)."""
    with annotate("kernel.fused_o_branch_vjp"):
        return twin_vjp(
            lambda *a: fused_o_branch_twin(*a, out_dtype=out_dtype),
            (d, wm, bm, w2, b2), g)


def check_o_operands(d, wm, bm, w2, b2):
    """Shapes of the o-branch operands; returns (B, H, W, N, 2C)."""
    b, h, w, one = d.shape
    n, nine, c2 = wm.shape
    if (one != 1 or nine != 9 or tuple(bm.shape) != (n, c2)
            or w2.numel() != n * 9 * c2 * c2 or tuple(b2.shape) != (n, c2)):
        raise ValueError(
            f"o-branch operands disagree: d {tuple(d.shape)}, wm "
            f"{tuple(wm.shape)}, bm {tuple(bm.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}")
    if c2 not in (16, 32, 64, 128):
        raise ValueError(f"the kernel takes 2C = 16, 32, 64 or 128, got {c2}")
    if n > 65535 or b > 65535:
        raise ValueError(f"the kernel takes N, B ≤ 65535, got {n}, {b}")
    return b, h, w, n, c2


def fused_o_branch_route(dtype, c2, ptrs, k=0):
    """Which kernel a CUDA call takes: ``"wgmma"``, ``"mma"`` or ``"fp32"``.
    ``ptrs``: the operands' base addresses; ``k``: the mask's depth bins
    (``fused_modulation``; 0 for the o-branch alone)."""
    if dtype == torch.float32:
        return "fp32"
    if c2 in (64, 128) and k <= 16 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "mma"


def o_branch_pack_index(c2):
    """Flat indices into one instance's w2 [9, 2C in, 2C out] of the order
    the ``wgmma`` kernel streams, [2C/64 slices, 9 taps, 2C o, 8 pieces,
    8]: the piece stored at position j of row o is the logical piece
    j ^ (o & 7) of the slice's 64 input channels (the 128-byte
    shared-memory swizzle)."""
    s, t, o, j, q = np.meshgrid(np.arange(c2 // 64), np.arange(9),
                                np.arange(c2), np.arange(8), np.arange(8),
                                indexing="ij")
    c = s * 64 + (j ^ (o & 7)) * 8 + q
    return ((t * c2 + c) * c2 + o).reshape(-1)


def o_branch_pack_weights(w2):
    """w2 [N, 9, 2C, 2C] (or [N, 9·2C, 2C]) → [N, 2C/64, 9, 2C, 64]: one
    [o, c] tile (c contiguous, pieces swizzled) per instance, 64-channel
    slice and tap. One gather."""
    n, c2 = w2.shape[0], w2.shape[-1]
    if c2 % 64:
        raise ValueError(f"w2 {tuple(w2.shape)}: 2C must be a multiple of 64")
    idx = device_constant(o_branch_pack_index, (c2,), torch.int64, w2.device)
    return w2.reshape(n, -1)[:, idx].reshape(n, c2 // 64, 9, c2, 64)


def o_branch_unpack_weights(packed):
    """Inverse of :func:`o_branch_pack_weights`: → w2 [N, 9, 2C, 2C]."""
    n, c2 = packed.shape[0], packed.shape[3]
    idx = device_constant(o_branch_pack_index, (c2,), torch.int64,
                          packed.device)
    flat = torch.empty((n, 9 * c2 * c2), dtype=packed.dtype,
                       device=packed.device)
    flat[:, idx] = packed.reshape(n, -1)
    return flat.reshape(n, 9, c2, c2)


def _o_prepare(d, wm, bm, w2, b2, out_dtype):
    b, h, w, n, c2 = check_o_operands(d, wm, bm, w2, b2)
    dt = out_dtype or d.dtype
    dd = d.to(dt).contiguous()
    ops = [t.to(dt).contiguous() for t in (wm, bm, w2, b2)]
    out = torch.empty((b, h, w, n * c2), dtype=dt, device=d.device)
    return (b, h, w, n, c2), dt, dd, ops, out


def launch_mma(d, wm, bm, w2, b2, out_dtype=None):
    """Launch the tile kernel (routes ``"mma"`` and ``"fp32"``) on CUDA
    operands; counts nothing."""
    fn = _build.load("fused_mod", "fused_o_branch")
    (b, h, w, n, c2), dt, dd, ops, out = _o_prepare(d, wm, bm, w2, b2,
                                                    out_dtype)
    code = fn(_build.dtype_code(dt), dd.data_ptr(),
              *(t.data_ptr() for t in ops), out.data_ptr(), b, h, w, n, c2,
              _build.stream_ptr(d.device))
    _build.check("fused_mod", code, "fused_o_branch")
    return out


def launch_wgmma(d, wm, bm, w2, b2, out_dtype=None, lib="fused_mod"):
    """Launch the ``wgmma`` kernel (route ``"wgmma"``) on CUDA operands;
    counts nothing. ``lib``: the library that exports ``fused_mod_wgmma``
    (another build of the source, to time or profile two versions)."""
    fn = _build.load(lib, "fused_mod_wgmma")
    (b, h, w, n, c2), dt, dd, (wm_, bm_, w2_, b2_), out = _o_prepare(
        d, wm, bm, w2, b2, out_dtype)
    with annotate("net.prepare"):
        wp = o_branch_pack_weights(w2_)
    code = fn(0, dd.data_ptr(), None, wm_.data_ptr(), bm_.data_ptr(),
              wp.data_ptr(), None, b2_.data_ptr(), out.data_ptr(), b, h, w, n,
              c2, 0, _build.stream_ptr(d.device))
    _build.check(lib, code, "fused_mod_wgmma")
    return out


def fused_o_branch(d, wm, bm, w2, b2, out_dtype=None):
    """All N depth-map branches of one depth map in one pass →
    [B,H,W,N·2C] in ``out_dtype`` (default ``d.dtype``).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`fused_o_branch_route` names (and raises if it cannot).
    Under autograd the backward is :func:`fused_o_branch_vjp`."""
    with annotate("kernel.fused_o_branch"):
        return differentiable(
            lambda *a: _forward(*a, out_dtype),
            lambda saved, g: fused_o_branch_vjp(*saved, g, out_dtype),
            (d, wm, bm, w2, b2))


def _forward(d, wm, bm, w2, b2, out_dtype):
    if d.device.type == "cpu":
        return fused_o_branch_plain(d, wm, bm, w2, b2, out_dtype)
    c2 = check_o_operands(d, wm, bm, w2, b2)[4]
    dt = out_dtype or d.dtype
    route = fused_o_branch_route(
        dt, c2, [t.data_ptr() for t in (d, wm, bm, w2, b2)])
    launch = launch_wgmma if route == "wgmma" else launch_mma
    out = launch(d, wm, bm, w2, b2, out_dtype)
    fused_o_branch.launches += 1
    fused_o_branch.routes[route] += 1
    return out


fused_o_branch.launches = 0
fused_o_branch.routes = {"wgmma": 0, "mma": 0, "fp32": 0}
