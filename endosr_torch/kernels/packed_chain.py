"""Phase-packed stage chain g1→g2→g3 of both ×8 packed chains.

Port of ``endosr/kernels/packed_chain.py::packed_g123`` (TPU kernel
``pallas_call`` at ``:438``, twin ``packed_g123_reference`` at ``:100``)
and ``unfold_g4_phases`` (``:50``):

    g1 = gate₁(lrelu(x ⊛ K1 + b1))          pads (1,1)(1,1), s=1
    g2 = gate₀(relu(g1 ⊛ K2 + b2))          pads (0,1)(0,1), s=0
    g3 = gate₁(relu(g1 + g2 ⊛ K3 + b3))     pads (1,0)(1,0), s=1

with [2,2,4C,4C′] packed kernels, and with ``k4``/``b4`` the absorbed
ungated stage 4 of the twin (``:135-138``):

    g4 = lrelu(g3 ⊛ K4 + b4)                pads (0,1)(0,1), no gate

``endosr_torch/csrc/packed_chain.cu``
holds one packed stage in two hand-written kernels, and
:func:`packed_g123_route` picks one by shape, never by trial; the wrapper
runs the three stages as three calls, g1 and g2 through device memory:

- ``"wgmma"``: bf16, Cin4 % 64 == 0, C4 = 128, x's channel stride 1, its
  other strides multiples of 8 and a 16-byte aligned base. The implicit
  GEMM on ``wgmma`` of ``csrc/conv_wgmma.cuh`` with 2×2 taps (TMA halo
  tiles activated in place once, the ``phases`` interleave an address map
  of four phase boxes); the weights stream as swizzled 64 × 64 tiles that
  :func:`packed_stage_pack_weights` arranges once per call. A stage whose
  width is one to eight columns past a multiple of 64 (129, 257) runs
  that strip as a second launch of the same kernel on the transposed view,
  so no tile column is computed and thrown away.
- ``"mma"``: any other bf16 shape, the shared warp-``mma`` implicit GEMM.
- ``"fp32"``: float32 storage, an exact fp32 loop on the CUDA cores.

Stage 1 applies ``pre_bias``/``pre_act`` and the ``phases`` interleave while
it loads x, so neither an activated nor an interleaved copy of the producer
tensor is written. The chain is bound by operations (≈70 GFLOP for the up1
chain, ≈208 GFLOP for the tail chain). ``packed_g123.launches`` counts
calls (three stage launches each), ``packed_g123.routes`` counts them per
route. Stage 4 (``k4``/``b4`` [2,2,C4,C4out]; no JAX path passes it, JAX's
kernel tests do) is a fourth launch of the shared implicit GEMM
(``packed_stage``) with an ungated epilogue after either route, as C4out
need not be 128; ``packed_g123.routes`` counts it as ``"k4_mma"`` (bf16)
or ``"k4_fp32"``.
"""

from __future__ import annotations

import numpy as np
import torch

from endosr_torch.kernels import _build
from endosr_torch.kernels._autograd import differentiable, twin_vjp
from endosr_torch.nn.layers import conv2d_nhwc, leaky_relu, packed_gate
from endosr_torch.utils.device import device_constant

__all__ = ["packed_g123", "packed_g123_plain", "packed_g123_route",
           "packed_g123_vjp",
           "packed_stage_pack_weights", "packed_stage_unpack_weights",
           "launch_igemm", "launch_wgmma", "unfold_g4_phases"]


def unfold_g4_phases(g4_hwnc):
    """Interleave a phase-packed [Hg, Wg, B, 4C] HWNC tensor to the fine
    [2(Hg−1), 2(Wg−1), B, C] grid, z[2Y+a, 2X+b] = g4[Y, X, (2a+b)·C + o];
    the dead row/column Hg−1/Wg−1 is dropped."""
    hg, wg, b, c4g = g4_hwnc.shape
    c = c4g // 4
    gv = g4_hwnc[:hg - 1, :wg - 1].reshape(hg - 1, wg - 1, b, 2, 2, c)
    return gv.permute(0, 3, 1, 4, 2, 5).reshape(2 * (hg - 1), 2 * (wg - 1), b, c)


def _gate(g, s, c4):
    row, _ = packed_gate(g.shape[1] - 1, c4 // 4, s, g.dtype, g.device)
    _, col = packed_gate(g.shape[2] - 1, c4 // 4, s, g.dtype, g.device)
    return g * (row[:, None, :] * col[None, :, :])[None]


def packed_g123_plain(x_hwnc, k1, b1, k2, b2, k3, b3, pre_act=False,
                      pre_bias=None, phases=False, k4=None, b4=None):
    """Plain PyTorch version: the unfused stages on the BHWC view, in the
    twin's op and dtype order. Returns g3 [Nx+1, Mx+1, B, C4] (HWNC), or
    with ``k4``/``b4`` g4 [Nx+1, Mx+1, B, C4out]."""
    if phases:
        x_hwnc = unfold_g4_phases(x_hwnc)
    dt = x_hwnc.dtype
    x = x_hwnc.permute(2, 0, 1, 3)
    if pre_bias is not None:
        x = x + pre_bias.reshape(1, 1, 1, -1).to(dt)
    c4 = k1.shape[3]

    def pconv(a, k, pad, b_):
        return conv2d_nhwc(a, k, pad, dt) + b_.to(dt)

    if pre_act:
        x = leaky_relu(x)
    g1 = _gate(leaky_relu(pconv(x, k1, ((1, 1), (1, 1)), b1)), 1, c4)
    g2 = _gate(torch.relu(pconv(g1, k2, ((0, 1), (0, 1)), b2)), 0, c4)
    g3 = _gate(torch.relu(g1 + pconv(g2, k3, ((1, 0), (1, 0)), b3)), 1, c4)
    if k4 is not None:
        g3 = leaky_relu(pconv(g3, k4, ((0, 1), (0, 1)), b4))
    return g3.permute(1, 2, 0, 3)


def packed_g123_route(dtype, cin4, c4, strides, ptr=0):
    """Which kernel a CUDA call takes: ``"wgmma"``, ``"mma"`` or ``"fp32"``.
    ``strides``: x's element strides (row, column, batch, channel), of the
    packed tensor with ``phases``; ``ptr``: its base address."""
    if dtype == torch.float32:
        return "fp32"
    if (cin4 % 64 == 0 and c4 == 128 and strides[3] == 1
            and all(s % 8 == 0 for s in strides[:3]) and ptr % 16 == 0):
        return "wgmma"
    return "mma"


def stage_pack_index(cin, c4=128):
    """Flat indices into a stage's k [2,2,Cin,C4] of the order the
    ``wgmma`` stage streams, [Cin/64 slices, 4 taps, C4 o, 8 pieces, 8]:
    the piece stored at position j of row o is the logical piece j ^ (o & 7)
    (the 128-byte shared-memory swizzle)."""
    s, t, o, j, q = np.meshgrid(np.arange(cin // 64), np.arange(4),
                                np.arange(c4), np.arange(8), np.arange(8),
                                indexing="ij")
    c = s * 64 + (j ^ (o & 7)) * 8 + q
    return ((t * cin + c) * c4 + o).reshape(-1)


def packed_stage_pack_weights(k):
    """k [2,2,Cin,C4] → [Cin/64, 4, C4, 64]: the order the wgmma stage
    streams, one [o, c] tile (c contiguous) per 64-channel slice and tap,
    each row's 16-byte pieces swizzled. One gather."""
    cin, c4 = k.shape[2], k.shape[3]
    if cin % 64 or c4 % 64:
        raise ValueError(f"k {tuple(k.shape)}: needs Cin and C4 multiples "
                         "of 64")
    idx = device_constant(stage_pack_index, (cin, c4), torch.int64, k.device)
    return k.reshape(-1)[idx].reshape(cin // 64, 4, c4, 64)


def packed_stage_unpack_weights(packed):
    """Inverse of :func:`packed_stage_pack_weights`: → k [2,2,Cin,C4]."""
    cin, c4 = packed.shape[0] * 64, packed.shape[2]
    idx = device_constant(stage_pack_index, (cin, c4), torch.int64,
                          packed.device)
    flat = torch.empty(4 * cin * c4, dtype=packed.dtype, device=packed.device)
    flat[idx] = packed.reshape(-1)
    return flat.reshape(2, 2, cin, c4)


def _prepare(x_hwnc, ks, vs, pre_bias, phases):
    """Shapes, the operands in x's type, and the three outputs (BHWC)."""
    if phases:
        hg, wg, b, c4g = x_hwnc.shape
        nx, mx, cin4 = 2 * (hg - 1), 2 * (wg - 1), c4g // 4
    else:
        nx, mx, b, cin4 = x_hwnc.shape
    dt, dev = x_hwnc.dtype, x_hwnc.device
    ks = [k.to(dt).contiguous() for k in ks]
    vs = [v.to(dt).contiguous() for v in vs]
    pb = None if pre_bias is None else pre_bias.to(dt).contiguous()
    c4 = ks[0].shape[3]
    n, m = nx + 1, mx + 1
    gs = [torch.empty((b, n, m, c4), dtype=dt, device=dev) for _ in range(3)]
    return (nx, mx, n, m, b, cin4), ks, vs, pb, gs


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bhwc_strides(t):
    return (t.stride(1), t.stride(2), t.stride(0)) if t is not None else (0, 0, 0)


def _stage4(g3, k4, b4):
    """Stage 4 on the shared implicit GEMM, ungated (``gate_s`` −1):
    g3 [B, n, m, C4] (BHWC) → g4 [B, n, m, C4out] → its HWNC view."""
    fn = _build.load("packed_chain")
    b, n, m, c4 = g3.shape
    dt = g3.dtype
    k4, b4 = k4.to(dt).contiguous(), b4.to(dt).contiguous()
    c4o = k4.shape[3]
    g4 = torch.empty((b, n, m, c4o), dtype=dt, device=g3.device)
    code = fn(_build.dtype_code(dt), g3.data_ptr(), *_bhwc_strides(g3), n, m,
              n, m, b, c4, 0, None, 0, k4.data_ptr(), b4.data_ptr(), 0, 0,
              g4.data_ptr(), *_bhwc_strides(g4), c4o, None, 0, 0, 0, 1, -1,
              _build.stream_ptr(g3.device))
    _build.check("packed_chain", code)
    return g4.permute(1, 2, 0, 3)


def launch_igemm(x_hwnc, k1, b1, k2, b2, k3, b3, pre_act=False,
                 pre_bias=None, phases=False, k4=None, b4=None):
    """The three stages on the shared implicit GEMM (routes ``"mma"`` and
    ``"fp32"``), and stage 4 with ``k4``, on CUDA operands; counts nothing.
    Returns g3 (or g4) (HWNC)."""
    fn = _build.load("packed_chain")
    (nx, mx, n, m, b, cin4), ks, bs, pb, (g1, g2, g3) = _prepare(
        x_hwnc, (k1, k2, k3), (b1, b2, b3), pre_bias, phases)
    dt, c4 = x_hwnc.dtype, ks[0].shape[3]
    code_dt, stream = _build.dtype_code(dt), _build.stream_ptr(x_hwnc.device)
    xs = (x_hwnc.stride(0), x_hwnc.stride(1), x_hwnc.stride(2))
    gs = _bhwc_strides(g1)
    for (x, st, ex, cin, ph, p, act_in, k, bias, pad, out, res, act, gate_s) in (
            (x_hwnc, xs, (nx, mx), cin4, phases, pb, pre_act, ks[0], bs[0], 1,
             g1, None, 1, 1),
            (g1, gs, (n, m), c4, False, None, False, ks[1], bs[1], 0, g2, None,
             0, 0),
            (g2, gs, (n, m), c4, False, None, False, ks[2], bs[2], 1, g3, g1,
             0, 1)):
        code = fn(code_dt, x.data_ptr(), *st, *ex, n, m, b, cin, int(ph),
                  _ptr(p), int(act_in), k.data_ptr(), bias.data_ptr(), pad,
                  pad, out.data_ptr(), *_bhwc_strides(out), c4, _ptr(res),
                  *_bhwc_strides(res), act, gate_s, stream)
        _build.check("packed_chain", code)
    if k4 is not None:
        return _stage4(g3, k4, b4)
    return g3.permute(1, 2, 0, 3)


def launch_wgmma(x_hwnc, k1, b1, k2, b2, k3, b3, pre_act=False,
                 pre_bias=None, phases=False, lib="packed_chain", k4=None,
                 b4=None):
    """The three stages on the ``wgmma`` kernel (route ``"wgmma"``), and
    stage 4 with ``k4`` on the shared implicit GEMM, on CUDA operands;
    counts nothing. Returns g3 (or g4) (HWNC). ``lib``: the library that
    exports ``packed_stage_wgmma`` (another build of the source, to time two
    versions)."""
    fn = _build.load(lib, "packed_stage_wgmma")
    (nx, mx, n, m, b, cin4), ks, bs, pb, (g1, g2, g3) = _prepare(
        x_hwnc, (k1, k2, k3), (b1, b2, b3), pre_bias, phases)
    stream = _build.stream_ptr(x_hwnc.device)
    xs = (x_hwnc.stride(0), x_hwnc.stride(1), x_hwnc.stride(2))
    gs = _bhwc_strides(g1)
    for (x, st, ex, cin, ph, p, act_in, k, bias, pad, out, res, act, gate_s) in (
            (x_hwnc, xs, (nx, mx), cin4, phases, pb, pre_act, ks[0], bs[0], 1,
             g1, None, 1, 1),
            (g1, gs, (n, m), 128, False, None, False, ks[1], bs[1], 0, g2,
             None, 0, 0),
            (g2, gs, (n, m), 128, False, None, False, ks[2], bs[2], 1, g3, g1,
             0, 1)):
        wp = packed_stage_pack_weights(k)
        code = fn(x.data_ptr(), *st, *ex, n, m, b, cin, int(ph), _ptr(p),
                  int(act_in), wp.data_ptr(), bias.data_ptr(), pad, out.data_ptr(),
                  *_bhwc_strides(out), _ptr(res), *_bhwc_strides(res), act,
                  gate_s, stream)
        _build.check(lib, code, "packed_stage_wgmma")
    if k4 is not None:
        return _stage4(g3, k4, b4)
    return g3.permute(1, 2, 0, 3)


def packed_g123_vjp(x_hwnc, k1, b1, k2, b2, k3, b3, pre_bias, g,
                    pre_act=False, phases=False, k4=None, b4=None):
    """The backward of :func:`packed_g123` (the JAX ``_bwd``,
    ``packed_chain.py:457-493``): the VJP of the plain version at the
    saved inputs, the forward recomputed. Returns the gradients of (x, k1,
    b1, k2, b2, k3, b3, pre_bias), None for a missing ``pre_bias``, and
    with ``k4`` those of (k4, b4) after them."""
    if k4 is None:
        return twin_vjp(
            lambda x, *a: packed_g123_plain(x, *a[:6], pre_act, a[6], phases),
            (x_hwnc, k1, b1, k2, b2, k3, b3, pre_bias), g)
    return twin_vjp(
        lambda x, *a: packed_g123_plain(x, *a[:6], pre_act, a[6], phases,
                                        a[7], a[8]),
        (x_hwnc, k1, b1, k2, b2, k3, b3, pre_bias, k4, b4), g)


def packed_g123(x_hwnc, k1, b1, k2, b2, k3, b3, pre_act=False,
                pre_bias=None, phases=False, k4=None, b4=None):
    """Three-stage packed chain (four with ``k4``/``b4``).

    x_hwnc: [Nx, Mx, B, Cin4] (HWNC), or with ``phases`` the packed
    producer [Hg, Wg, B, 4·Cin4] whose fine grid is interleaved at load
    time; k1 [2,2,Cin4,C4], k2/k3 [2,2,C4,C4]; b* group-tiled [C4].
    ``pre_act``: x is a raw producer output whose leaky_relu(0.2) is
    applied here; ``pre_bias`` [Cin4]: its deferred bias, added first.
    ``k4`` [2,2,C4,C4out] / ``b4`` [C4out]: the absorbed ungated stage 4.
    Returns g3 [Nx+1, Mx+1, B, C4] (or g4 [.., C4out]) (HWNC view of a
    BHWC tensor).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`packed_g123_route` names (three stage launches, four with
    ``k4``, counted as one call) or raises. Under autograd the backward is
    :func:`packed_g123_vjp`."""
    if (k4 is None) != (b4 is None):
        raise ValueError("k4 and b4 come together")
    if k4 is None:
        return differentiable(
            lambda x, *a: _forward(x, *a[:6], pre_act, a[6], phases),
            lambda saved, g: packed_g123_vjp(*saved, g, pre_act=pre_act,
                                             phases=phases),
            (x_hwnc, k1, b1, k2, b2, k3, b3, pre_bias))
    return differentiable(
        lambda x, *a: _forward(x, *a[:6], pre_act, a[6], phases, a[7], a[8]),
        lambda saved, g: packed_g123_vjp(*saved[:8], g, pre_act=pre_act,
                                         phases=phases, k4=saved[8],
                                         b4=saved[9]),
        (x_hwnc, k1, b1, k2, b2, k3, b3, pre_bias, k4, b4))


def _forward(x_hwnc, k1, b1, k2, b2, k3, b3, pre_act, pre_bias, phases,
             k4=None, b4=None):
    if x_hwnc.device.type == "cpu":
        return packed_g123_plain(x_hwnc, k1, b1, k2, b2, k3, b3, pre_act,
                                 pre_bias, phases, k4, b4)
    c4g = x_hwnc.shape[3]
    cin4 = c4g // 4 if phases else c4g
    c4 = k1.shape[3]
    if x_hwnc.stride(3) != 1 or cin4 % 16 or c4 % 16:
        raise ValueError(f"x {tuple(x_hwnc.shape)} strides {x_hwnc.stride()}: "
                         "channels must be contiguous and multiples of 16")
    if k4 is not None and (k4.shape[:3] != (2, 2, c4) or k4.shape[3] % 16):
        raise ValueError(f"k4 {tuple(k4.shape)}: must be [2,2,{c4},C4out] "
                         "with C4out a multiple of 16")
    if pre_bias is not None and not pre_act:
        raise ValueError("pre_bias requires pre_act")
    route = packed_g123_route(x_hwnc.dtype, cin4, c4, x_hwnc.stride(),
                              x_hwnc.data_ptr())
    launch = launch_wgmma if route == "wgmma" else launch_igemm
    out = launch(x_hwnc, k1, b1, k2, b2, k3, b3, pre_act, pre_bias, phases,
                 k4=k4, b4=b4)
    packed_g123.launches += 1
    packed_g123.routes[route] += 1
    if k4 is not None:
        packed_g123.routes["k4_fp32" if route == "fp32" else "k4_mma"] += 1
    return out


packed_g123.launches = 0
packed_g123.routes = {"wgmma": 0, "mma": 0, "fp32": 0, "k4_mma": 0,
                      "k4_fp32": 0}
