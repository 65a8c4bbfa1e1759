"""Core layers of the port, NHWC at every public function.

Counterpart of ``endosr/nn/layers.py``. Parameters are stored the way the
reference PyTorch checkpoints store them (OIHW convolution weights,
``weight_v``/``weight_g`` for weight norm, ``(I, O, kh, kw)`` for a
transposed convolution), so a reference ``state_dict`` loads as it is.
The functions that rewrite kernels (folding through a pixel shuffle,
phase packing) take and return HWIO kernels, as their JAX counterparts
do, so the two can be compared entry by entry.

Activations stay NHWC like the JAX package; a convolution runs as
``F.conv2d`` on the NCHW view of an NHWC tensor (a channels-last tensor,
no copy).

Inside a ``parallel/spatial.py::spatial`` block (H-sharded serving) the
convolutions take their halo rows from the neighbouring ranks, the valid
masks are built in global rows and the masked InstanceNorms sum their
statistics over the ranks; the norms over the whole image that no masked
forward runs refuse to run there.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from endosr_torch.parallel.spatial import active as spatial_active
from endosr_torch.utils.device import device_constant

__all__ = [
    "Conv", "WNConv", "ConvTranspose", "WNConvTranspose", "Dense",
    "init_leaves_", "torch_conv_init_", "wn_effective_kernel", "conv2d_nhwc", "hwio",
    "instance_norm", "chained_instance_norm", "masked_instance_norm",
    "masked_chained_instance_norm", "valid_mask", "pixel_shuffle",
    "leaky_relu", "clip", "centered_conv",
    "fold_kernel_through_pixel_shuffle", "packed_stage_kernel",
    "packed_gate", "compose_pixel_shuffle_perm",
]


def torch_conv_init_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """Fill ``t`` with U(−1/√fan_in, 1/√fan_in), torch Conv2d's default
    (``layers.torch_conv_init`` on the JAX side). Drawn on the CPU from
    ``gen`` so a seed gives the same weights on every device."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    v = torch.rand(t.shape, generator=gen, dtype=torch.float32)
    with torch.no_grad():
        t.copy_(v * (2 * bound) - bound)


def _norm_on_host(v: torch.Tensor) -> torch.Tensor:
    """‖v‖ over all but the first axis, [O, 1, 1, 1], computed on the CPU
    (the seeded init's gains are then the same on every device)."""
    return v.detach().float().cpu().square().sum(dim=(1, 2, 3),
                                                 keepdim=True).sqrt()


def hwio(w_oihw: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight → the JAX package's HWIO layout (a view)."""
    return w_oihw.permute(2, 3, 1, 0)


def _pads(pad):
    if isinstance(pad, int):
        return (pad, pad), (pad, pad)
    return tuple(pad[0]), tuple(pad[1])


def conv2d_nhwc(x, w_hwio, pad=1, dtype=None, stride=1, groups=1):
    """Conv of NHWC ``x`` with an HWIO kernel in ``dtype`` (default
    ``x.dtype``); ``pad`` is an int or ((top, bottom), (left, right));
    ``groups``: the kernel is [kh,kw,C_in/groups,C_out], output channels
    group-major. No bias. Returns NHWC. In a spatial block ``x`` is this
    rank's row slab, and so is the output."""
    dtype = dtype or x.dtype
    (pt, pb), (pl, pr) = _pads(pad)
    sp = spatial_active()
    if sp is not None:
        x = sp.conv_rows(x, w_hwio.shape[0], stride, pt, pb)
        pt = pb = 0
    xn = x.to(dtype).permute(0, 3, 1, 2)
    w = w_hwio.to(dtype).permute(3, 2, 0, 1)
    if pt == pb and pl == pr:
        y = F.conv2d(xn, w, stride=stride, padding=(pt, pl), groups=groups)
    else:
        y = F.conv2d(F.pad(xn, (pl, pr, pt, pb)), w, stride=stride,
                     groups=groups)
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=16)
def _in_dtype(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(value, dtype=dtype).item()


def leaky_relu(x, negative_slope: float = 0.2):
    """max(x, s·x), with s rounded to x's dtype as the JAX twin does (the
    fp32 product of two bf16 values is exact, so rounding it equals the
    bf16 multiply)."""
    return torch.maximum(x, x * _in_dtype(negative_slope, x.dtype))


def clip(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)``: the maximum with ``lo``, then the minimum
    with ``hi``, the bounds rounded to x's dtype (as ``torch.clamp`` rounds
    them, so the values are ``torch.clamp``'s). A value at a bound passes
    half the gradient, as in JAX (``torch.clamp`` passes all of it). With
    no gradient to pass it is the one ``torch.clamp`` pass."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, lo, hi)
    lo_t = device_constant(float, (lo,), x.dtype, x.device)
    hi_t = device_constant(float, (hi,), x.dtype, x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


@contextlib.contextmanager
def _tf32_convs(device):
    """cuDNN's convolutions on ``device`` may use TF32 inside the block,
    whatever the process-wide flag says; it is restored on leaving. The
    flag is the process's, so other threads see it set meanwhile."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _exact_product_conv(a, w, pad):
    """SAME conv of NHWC ``a`` with HWIO ``w``, both holding bf16 values:
    fp32 products (exact: 8-bit by 8-bit significands), fp32 sums and an
    fp32 result, as JAX's bf16 conv with ``preferred_element_type=f32``.
    ``F.conv2d`` of the bf16 tensors would round the result to bf16, so the
    operands are widened to fp32; on CUDA cuDNN may take TF32 tensor cores
    for them, whose 10-bit operands still hold a bf16 value exactly."""
    with _tf32_convs(a.device):
        return conv2d_nhwc(a.float(), w.float(), pad, torch.float32)


def _border_index(n: int, p: int) -> np.ndarray:
    """[n]: the border case of every row (or column) of an n-long axis for
    a (2p+1)-tap SAME conv: 0..p-1 the first p, p inside, p+1..2p the last
    p."""
    idx = np.full(n, p, np.int64)
    idx[:p] = np.arange(p)
    idx[n - p:] = np.arange(p + 1, 2 * p + 1)
    return idx


def _constant_image_conv(m, w32, h: int, wd: int):
    """The exact fp32 SAME conv of the constant image m·1 [B, h, wd, Cin]
    by HWIO ``w32``: an output row sees a contiguous tap range, so there
    are (2p+1)² border cases, taken from two cumulative sums of the
    kernel. Returns [B, h, wd, Cout]."""
    k = w32.shape[0]
    p = k // 2
    zero = w32.new_zeros((1,) + tuple(w32.shape[1:]))
    cs_r = torch.cat([zero, w32]).cumsum(0)
    rows = ([cs_r[k] - cs_r[p - c] for c in range(p)] + [cs_r[k] - cs_r[0]]
            + [cs_r[2 * p - c] - cs_r[0] for c in range(p)])
    s_r = torch.stack(rows)                              # [2p+1, k, Cin, Cout]
    cs_c = torch.cat([s_r.new_zeros((2 * p + 1, 1) + tuple(s_r.shape[2:])),
                      s_r], dim=1).cumsum(1)
    cols = ([cs_c[:, k] - cs_c[:, p - c] for c in range(p)]
            + [cs_c[:, k] - cs_c[:, 0]]
            + [cs_c[:, 2 * p - c] - cs_c[:, 0] for c in range(p)])
    s = torch.stack(cols, dim=1)                   # [2p+1, 2p+1, Cin, Cout]
    # in float64, then rounded: an fp32 einsum is a matmul, which
    # ``torch.set_float32_matmul_precision`` may turn into TF32
    v = torch.einsum("bi,rcio->brco", m.double(), s.double()).float()
    ridx = device_constant(_border_index, (h, p), torch.int64, m.device)
    cidx = device_constant(_border_index, (wd, p), torch.int64, m.device)
    return v[:, ridx][:, :, cidx]


def centered_conv(x, w, b, dtype, passes: int = 1):
    """Mean-compensated low-precision conv (``layers.centered_conv`` of the
    JAX package): stride 1, odd k×k HWIO kernel ``w``, SAME zero padding,
    NHWC. conv(x) = conv(x − m) + conv(m·1) with m the per-(sample,
    in-channel) mean: the first term in ``dtype`` on the centred data
    d = x − m (its rounding relative to the signal, not the offset), in
    ``passes`` exact-product passes d_hi·w_hi, + d_lo·w_hi, + d_hi·w_lo
    (d_lo and w_lo the parts bf16 rounding drops), the second exact in
    fp32. Returns fp32; a plain fp32 conv when ``dtype`` is fp32 or the
    image is smaller than the kernel. On CUDA the passes set cuDNN's
    process-wide TF32 flag for their length (:func:`_tf32_convs`), so an
    fp32 conv that another thread runs meanwhile may take TF32: the call
    is not thread-safe in that respect."""
    _whole_image_only("centered_conv")
    k = w.shape[0]
    p = k // 2
    h, wd = x.shape[1], x.shape[2]
    if dtype == torch.float32 or h < k or wd < k:
        y = conv2d_nhwc(x.float(), w.float(), p, torch.float32)
        return y if b is None else y + b.float()
    x32 = x.float()
    m = x32.mean(dim=(1, 2))                             # [B, Cin]
    d32 = x32 - m[:, None, None, :]
    d_hi, w_hi = d32.to(dtype), w.to(dtype)
    y = _exact_product_conv(d_hi, w_hi, p)
    if passes >= 2:
        d_lo = (d32 - d_hi.float()).to(dtype)
        y = y + _exact_product_conv(d_lo, w_hi, p)
    if passes >= 3:
        w_lo = (w.float() - w_hi.float()).to(dtype)
        y = y + _exact_product_conv(d_hi, w_lo, p)
    y = y + _constant_image_conv(m, w.float(), h, wd)
    return y if b is None else y + b.float()


def _check_centered(centered, k, stride, padding):
    if centered and (stride != 1 or padding != k // 2 or k % 2 == 0):
        raise ValueError("a centered conv needs stride 1, an odd kernel and "
                         "SAME padding")


class Conv(nn.Module):
    """Plain conv (torch ``Conv2d`` parameters), NHWC in and out.
    ``centered`` = N > 0 runs it as an N-pass :func:`centered_conv` in bf16
    (fp32 out; stride 1, SAME padding), whatever dtype the caller asks."""

    def __init__(self, in_ch, out_ch, k=3, stride=1, padding=1, bias=True,
                 centered=0, device=None):
        super().__init__()
        _check_centered(centered, k, stride, padding)
        self.stride, self.padding = stride, padding
        self.centered = int(centered)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(out_ch, device=device))
                     if bias else None)

    def init_(self, gen):
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        torch_conv_init_(self.weight, fan_in, gen)
        if self.bias is not None:
            torch_conv_init_(self.bias, fan_in, gen)

    def forward(self, x, dtype):
        if self.centered:
            return centered_conv(x, hwio(self.weight), self.bias,
                                 torch.bfloat16, self.centered)
        y = conv2d_nhwc(x, hwio(self.weight), self.padding, dtype, self.stride)
        return y if self.bias is None else y + self.bias.to(dtype)


class WNConv(nn.Module):
    """Weight-normalized conv: w = g · v/‖v‖ per output channel (torch
    ``weight_norm`` dim=0). ``centered`` as for :class:`Conv`."""

    def __init__(self, in_ch, out_ch, k=3, stride=1, padding=1, centered=0,
                 device=None):
        super().__init__()
        _check_centered(centered, k, stride, padding)
        self.stride, self.padding = stride, padding
        self.centered = int(centered)
        self.weight_v = nn.Parameter(torch.empty(out_ch, in_ch, k, k,
                                                 device=device))
        self.weight_g = nn.Parameter(torch.empty(out_ch, 1, 1, 1,
                                                 device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def init_(self, gen):
        fan_in = self.weight_v[0].numel()
        torch_conv_init_(self.weight_v, fan_in, gen)
        with torch.no_grad():
            self.weight_g.copy_(_norm_on_host(self.weight_v))
        torch_conv_init_(self.bias, fan_in, gen)

    def forward(self, x, dtype):
        w, b = wn_effective_kernel(self)
        if self.centered:
            return centered_conv(x, w, b, torch.bfloat16, self.centered)
        return conv2d_nhwc(x, w, self.padding, dtype, self.stride) + b.to(dtype)


class Dense(nn.Module):
    """Linear layer (torch ``Linear`` parameters: an (O, I) weight), torch's
    default init U(±1/√in) for weight and bias."""

    def __init__(self, in_f, out_f, bias=True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_f, in_f, device=device))
        self.bias = (nn.Parameter(torch.empty(out_f, device=device))
                     if bias else None)

    def init_(self, gen):
        torch_conv_init_(self.weight, self.weight.shape[1], gen)
        if self.bias is not None:
            torch_conv_init_(self.bias, self.weight.shape[1], gen)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def init_leaves_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Seeded init of every parameter-holding leaf of ``module`` (each
    module without children that has an ``init_``), in registration
    order, from ``gen``."""
    for m in module.modules():
        if not any(True for _ in m.children()) and hasattr(m, "init_"):
            m.init_(gen)
    return module


def wn_effective_kernel(m: WNConv):
    """fp32 effective HWIO kernel g·v/‖v‖ and bias of a :class:`WNConv`."""
    v32 = m.weight_v.float()
    norm = v32.square().sum(dim=(1, 2, 3), keepdim=True).sqrt()
    w = v32 * (m.weight_g.float() / norm)
    return hwio(w), m.bias.float()


def _conv_transpose_nhwc(x, w_iokk, b, stride, padding, dtype):
    """torch ``conv_transpose2d`` of NHWC ``x`` with an (I, O, kh, kw)
    weight, plus bias, in ``dtype``; out = (in−1)·s − 2p + k. In a spatial
    block, this rank's s·(slab rows) output rows (the whole output taken as
    in·s rows; ``parallel/spatial.py``)."""
    def conv(t):
        return F.conv_transpose2d(t.to(dtype).permute(0, 3, 1, 2),
                                  w_iokk.to(dtype), stride=stride,
                                  padding=padding).permute(0, 2, 3, 1)

    sp = spatial_active()
    y = conv(x) if sp is None else sp.conv_transpose_rows(
        x, w_iokk.shape[2], stride, padding, conv)
    return y + b.to(dtype)


class ConvTranspose(nn.Module):
    """ConvTranspose2d (torch parameters: an (I, O, kh, kw) weight and a
    bias), NHWC in and out; out = (in−1)·s − 2p + k. The JAX package keeps
    the kernel as (kh, kw, I, O) and flips it spatially when it is called;
    ``utils/port_params.py`` maps one to the other."""

    def __init__(self, in_ch, out_ch, k=3, stride=2, padding=1, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, k, k,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def init_(self, gen):
        # torch's fan-in convention for a transposed conv: out·kh·kw
        fan_in = self.weight[0].numel()
        torch_conv_init_(self.weight, fan_in, gen)
        torch_conv_init_(self.bias, fan_in, gen)

    def forward(self, x, dtype):
        return _conv_transpose_nhwc(x, self.weight, self.bias, self.stride,
                                    self.padding, dtype)


class WNConvTranspose(nn.Module):
    """Weight-normalized ConvTranspose2d (norm per INPUT channel, torch
    dim=0 on the (I, O, kh, kw) weight); out = (in−1)·s − 2p + k."""

    def __init__(self, in_ch, out_ch, k=3, stride=2, padding=1, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_v = nn.Parameter(torch.empty(in_ch, out_ch, k, k,
                                                 device=device))
        self.weight_g = nn.Parameter(torch.empty(in_ch, 1, 1, 1,
                                                 device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def init_(self, gen):
        # torch's fan-in convention for a transposed conv: out·kh·kw
        fan_in = self.weight_v[0].numel()
        torch_conv_init_(self.weight_v, fan_in, gen)
        with torch.no_grad():
            self.weight_g.copy_(_norm_on_host(self.weight_v))
        torch_conv_init_(self.bias, fan_in, gen)

    def forward(self, x, dtype):
        v32 = self.weight_v.float()
        norm = v32.square().sum(dim=(1, 2, 3), keepdim=True).sqrt()
        w = v32 * (self.weight_g.float() / norm)
        return _conv_transpose_nhwc(x, w, self.bias, self.stride,
                                    self.padding, dtype)


def instance_norm(x, eps: float = 1e-5, stats: str = "default"):
    """Parameter-free InstanceNorm (NHWC), one-pass fp32 sum/sum-of-squares,
    variance clamped at 0; output in x's dtype. ``stats="kernel"`` takes
    the two sums from :func:`endosr_torch.kernels.in_stats.in_stats` (the
    JAX package's ``ENDOSR_IN_STATS=pallas``)."""
    _whole_image_only("instance_norm")
    x32 = x.float()
    n = x.shape[1] * x.shape[2]
    if stats == "kernel":
        from endosr_torch.kernels.in_stats import in_stats

        s, sq = (t[:, None, None, :] for t in in_stats(x))
    elif stats == "default":
        s = x32.sum(dim=(1, 2), keepdim=True)
        sq = (x32 * x32).sum(dim=(1, 2), keepdim=True)
    else:
        raise ValueError(f"stats must be 'default' or 'kernel', got {stats!r}")
    mean = s / n
    var = torch.clamp(sq / n - mean * mean, min=0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def chained_instance_norm(x, eps: float = 1e-5):
    """``instance_norm(instance_norm(x))`` from one statistics pass: the
    second norm's statistics are mean 0 and var/(var+eps)."""
    _whole_image_only("chained_instance_norm")
    x32 = x.float()
    n = x.shape[1] * x.shape[2]
    s = x32.sum(dim=(1, 2), keepdim=True)
    sq = (x32 * x32).sum(dim=(1, 2), keepdim=True)
    mean = s / n
    var = torch.clamp(sq / n - mean * mean, min=0.0)
    scale = torch.rsqrt(var + eps) * torch.rsqrt(var / (var + eps) + eps)
    return ((x32 - mean) * scale).to(x.dtype)


def _whole_image_only(name):
    """Refuse a whole-image statistic inside a spatial block (no masked
    forward runs it; a slab's statistic would be wrong)."""
    if spatial_active() is not None:
        raise NotImplementedError(
            f"{name} over a row slab: spatial sharding runs the masked "
            "(bucketed) forward only")


def _masked_sums(x, vmask):
    """(x·vmask, valid count, Σ, Σ²) over H, W; in a spatial block the
    count and sums are the whole image's (summed over the ranks)."""
    x32 = x.float() * vmask
    n = vmask.sum(dim=(1, 2), keepdim=True)
    s = x32.sum(dim=(1, 2), keepdim=True)
    sq = (x32 * x32).sum(dim=(1, 2), keepdim=True)
    sp = spatial_active()
    if sp is not None:
        n, s, sq = sp.sum(n, s, sq)
    return x32, n, s, sq


def masked_instance_norm(x, vmask, eps: float = 1e-5):
    """:func:`instance_norm` over the valid region only (exact bucketed
    eval): ``vmask`` is a [B|1,H,W,1] float 0/1 mask, the statistics divide
    by its count instead of H·W, and the output is zero outside it."""
    x32, n, s, sq = _masked_sums(x, vmask)
    mean = s / n
    var = torch.clamp(sq / n - mean * mean, min=0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps) * vmask).to(x.dtype)


def masked_chained_instance_norm(x, vmask, eps: float = 1e-5):
    """:func:`chained_instance_norm` with valid-region statistics (see
    :func:`masked_instance_norm`); output zero outside the valid region."""
    x32, n, s, sq = _masked_sums(x, vmask)
    mean = s / n
    var = torch.clamp(sq / n - mean * mean, min=0.0)
    scale = torch.rsqrt(var + eps) * torch.rsqrt(var / (var + eps) + eps)
    return ((x32 - mean) * scale * vmask).to(x.dtype)


def valid_mask(shape_hw, hv: int, wv: int, dtype=torch.float32, device=None):
    """[1, H, W, 1] mask that is 1 on rows < ``hv`` and columns < ``wv``,
    built on ``device`` (no host-to-device copy). In a spatial block H is
    the slab's and the rows are counted from the slab's first global
    row."""
    h, w = shape_hw
    sp = spatial_active()
    first = 0 if sp is None else sp.offset(h)
    r = torch.arange(first, first + h, device=device)[:, None] < hv
    c = torch.arange(w, device=device)[None, :] < wv
    return (r & c).to(dtype)[None, :, :, None]


def pixel_shuffle(x, r: int):
    """torch ``PixelShuffle`` on NHWC: [B,H,W,C·r²] → [B,H·r,W·r,C]
    (in-channel index c·r² + i·r + j)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def fold_kernel_through_pixel_shuffle(w, r: int):
    """HWIO k×k kernel that runs after PixelShuffle(r) → the equivalent
    [t,t,C_in·r²,C_out·r²] kernel that runs before it (exact)."""
    k = w.shape[0]
    if w.shape[1] != k or k % 2 != 1:
        raise ValueError(f"odd square kernel expected, got {tuple(w.shape)}")
    c_in, c_out = w.shape[2], w.shape[3]
    t = 2 * (-(-(k // 2) // r)) + 1
    u, v, pq, ij, ty, tx = device_constant(_fold_index, (k, r), torch.int64,
                                           w.device)
    w6 = torch.zeros((t, t, c_in, r * r, c_out, r * r), dtype=w.dtype,
                     device=w.device)
    # the (u, v, pq, ij) tuples are distinct, so one assignment is exact
    w6[u, v, :, pq, :, ij] = w[ty, tx]
    return w6.reshape(t, t, c_in * r * r, c_out * r * r)


def _fold_index(k: int, r: int) -> np.ndarray:
    """[6, L] (u, v, pq, ij, tap row, tap col) of every (phase, tap) pair
    of :func:`fold_kernel_through_pixel_shuffle`."""
    pad = k // 2
    half = -(-pad // r)
    i, j, dy, dx = np.meshgrid(
        np.arange(r), np.arange(r),
        np.arange(-pad, pad + 1), np.arange(-pad, pad + 1), indexing="ij")
    i, j, dy, dx = (a.ravel() for a in (i, j, dy, dx))
    return np.stack([(i + dy) // r + half, (j + dx) // r + half,
                     (i + dy) % r * r + (j + dx) % r, i * r + j,
                     dy + pad, dx + pad])


def packed_stage_kernel(w, s_in: int, s_out: int, in_interleaved=False):
    """Phase-packed [2,2,4C,4C'] lowering of a 3×3 SAME conv on a
    PS(2)-pending grid (see ``endosr/nn/layers.py::packed_stage_kernel``
    for the packing convention). Output channels group-major; input
    group-major, or c·4 + (a·2+b) with ``in_interleaved``."""
    k, c_in, c_out = w.shape[0], w.shape[2], w.shape[3]
    if k != 3 or w.shape[1] != 3:
        raise ValueError(f"3×3 kernel expected, got {tuple(w.shape)}")
    mm = device_constant(_packed_mix, (s_in, s_out), w.dtype, w.device)
    eq = "uvigyx,yxcd->uvcigd" if in_interleaved else "uvigyx,yxcd->uvicgd"
    return torch.einsum(eq, mm, w).reshape(2, 2, 4 * c_in, 4 * c_out)


def _packed_mix(s_in: int, s_out: int) -> np.ndarray:
    """The 0/1 [u, v, g_in, g_out, ky, kx] tap-mixing tensor of
    :func:`packed_stage_kernel`."""
    taps = []
    for alpha in (0, 1):
        for d in (-1, 0, 1):
            a = (alpha + d) % 2
            off = -s_out * alpha + (alpha + d - a) // 2 + s_in * a
            taps.append((alpha, d, a, off))
    lo = -min(t[3] for t in taps)
    m = np.zeros((2, 2, 4, 4, 3, 3), np.float32)
    for alpha, dy, a, offy in taps:
        for beta, dx, b, offx in taps:
            m[offy + lo, offx + lo, a * 2 + b, alpha * 2 + beta,
              dy + 1, dx + 1] += 1.0
    return m


def packed_gate(n: int, c_in: int, s: int, dtype=torch.float32, device=None):
    """(row, col) [n+1, 4C] 0/1 gates zeroing a packed tensor's
    out-of-fine-range slots (s=1: group a=0 dead at slot n, a=1 at slot 0;
    s=0: slot n dead for every group)."""
    row, col = device_constant(_packed_gate_np, (n, c_in, s), dtype, device)
    return row, col


def _packed_gate_np(n: int, c_in: int, s: int) -> np.ndarray:
    y = np.arange(n + 1)
    g0 = (y != n).astype(np.float32)
    g1 = (y != 0).astype(np.float32) if s else g0
    row = np.concatenate([np.tile((g0 if a == 0 else g1)[:, None], (1, c_in))
                          for a in (0, 0, 1, 1)], axis=1)
    col = np.concatenate([np.tile((g0 if b == 0 else g1)[:, None], (1, c_in))
                          for b in (0, 1, 0, 1)], axis=1)
    return np.stack([row, col])


def compose_pixel_shuffle_perm(r: int, s: int, channels: int) -> np.ndarray:
    """Permutation p with pixel_shuffle(pixel_shuffle(v, r), s) ==
    pixel_shuffle(v[..., p], s·r)."""
    sr = s * r
    m = np.arange(channels)
    c = m // (sr * sr)
    rem = m % (sr * sr)
    alpha, beta = rem // sr, rem % sr
    a, p = alpha // s, alpha % s
    b, q = beta // s, beta % s
    return ((c * s * s + p * s + q) * r * r + a * r + b).astype(np.int64)
