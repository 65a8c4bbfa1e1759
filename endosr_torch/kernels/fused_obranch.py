"""Fused SEAN depth-map branch of N instances (conv1 → ReLU → conv2).

Port of ``endosr/kernels/fused_obranch.py::fused_o_branch`` (TPU kernel
``pallas_call`` at ``:146``, twin ``fused_o_branch_reference`` at ``:51``):

    ob[b,y,x, n·2C+c] = conv3×3(relu(conv3×3(d; wm_n) + bm_n); w2_n)[c] + b2_n[c]

with conv2's padding ring of the activation zero (not ``relu(bm)``). The
CUDA kernel (``endosr_torch/csrc/fused_mod.cu``, shared with
``fused_modulation``) gives one block an 8×16-pixel tile of one image and
one instance: it computes conv1 + bias + ReLU on the tile's 10×18 halo into
shared memory, zero outside the image, rounded once to the storage type,
then runs conv2 as nine shifted [128 px, 2C] × [2C, 2C] products over that
tile (warp-level bf16 ``mma`` with fp32 accumulation, or an fp32 CUDA-core
loop), so the [B,H,W,N·2C] activation never reaches device memory. The sum
is rounded to the storage type, then the bias is added, as the twin does.
It is bound by operations (2·B·H·W·N·9·(2C)² ≈ 1.0 TFLOP at the flagship
shape). The TPU kernel's pre-cut row tiles and tap stack of the depth map,
and its bf16-only gate, are not copied: any H, W and both storage types run,
for 2C = 16, 32, 64 or 128.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from endosr_torch.kernels import _build

__all__ = ["fused_o_branch", "fused_o_branch_plain", "o_actv_plain",
           "acc_dtype", "grouped_w2", "check_o_operands"]


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


def fused_o_branch(d, wm, bm, w2, b2, out_dtype=None):
    """All N depth-map branches of one depth map in one pass →
    [B,H,W,N·2C] in ``out_dtype`` (default ``d.dtype``).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot)."""
    if d.device.type == "cpu":
        return fused_o_branch_plain(d, wm, bm, w2, b2, out_dtype)
    fn = _build.load("fused_mod", "fused_o_branch")
    b, h, w, n, c2 = check_o_operands(d, wm, bm, w2, b2)
    dt, dev = out_dtype or d.dtype, d.device
    dd = d.to(dt).contiguous()
    ops = [t.to(dt).contiguous() for t in (wm, bm, w2, b2)]
    out = torch.empty((b, h, w, n * c2), dtype=dt, device=dev)
    code = fn(_build.dtype_code(dt), dd.data_ptr(),
              *(t.data_ptr() for t in ops), out.data_ptr(), b, h, w, n, c2,
              _build.stream_ptr(dev))
    _build.check("fused_mod", code, "fused_o_branch")
    fused_o_branch.launches += 1
    return out


fused_o_branch.launches = 0
