"""Phase-packed stage chain g1→g2→g3 of both ×8 packed chains.

Port of ``endosr/kernels/packed_chain.py::packed_g123`` (TPU kernel
``pallas_call`` at ``:438``, twin ``packed_g123_reference`` at ``:100``)
and ``unfold_g4_phases`` (``:50``):

    g1 = gate₁(lrelu(x ⊛ K1 + b1))          pads (1,1)(1,1), s=1
    g2 = gate₀(relu(g1 ⊛ K2 + b2))          pads (0,1)(0,1), s=0
    g3 = gate₁(relu(g1 + g2 ⊛ K3 + b3))     pads (1,0)(1,0), s=1

with [2,2,4C,4C′] packed kernels. The CUDA kernel
(``endosr_torch/csrc/packed_chain.cu``) is one packed stage; the wrapper
launches it three times. Stage 1 applies ``pre_bias``/``pre_act`` and the
``phases`` interleave while it loads x, so neither an activated nor an
interleaved copy of the producer tensor is written. The chain is bound by
operations (≈70 GFLOP for the up1 chain, ≈210 GFLOP for the tail chain);
bf16 products run on the tensor cores through warp-level mma, fp32 on the
CUDA cores, and g1/g2 go through device memory. Absorbing stage 4
(``k4``/``b4``) is not on the serving path and is not ported.
"""

from __future__ import annotations

import torch

from endosr_torch.kernels import _build
from endosr_torch.nn.layers import conv2d_nhwc, leaky_relu, packed_gate

__all__ = ["packed_g123", "packed_g123_plain", "unfold_g4_phases"]


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
                      pre_bias=None, phases=False):
    """Plain PyTorch version: the unfused stages on the BHWC view, in the
    twin's op and dtype order. Returns g3 [Nx+1, Mx+1, B, C4] (HWNC)."""
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
    return g3.permute(1, 2, 0, 3)


def _stage(fn, dt, x, strides, nx, mx, n_out, m_out, b, cin, phases, pb,
           pre_act, k, bias, pad, out, res, act, gate_s):
    ost = (out.stride(1), out.stride(2), out.stride(0))      # out is BHWC
    rst = ((res.stride(1), res.stride(2), res.stride(0))
           if res is not None else (0, 0, 0))
    code = fn(_build.dtype_code(dt), x.data_ptr(), *strides, nx, mx, n_out,
              m_out, b, cin, int(phases),
              None if pb is None else pb.data_ptr(), int(pre_act),
              k.data_ptr(), bias.data_ptr(), pad, pad, out.data_ptr(), *ost,
              k.shape[3], None if res is None else res.data_ptr(), *rst,
              act, gate_s, _build.stream_ptr(x.device))
    _build.check("packed_chain", code)


def packed_g123(x_hwnc, k1, b1, k2, b2, k3, b3, pre_act=False,
                pre_bias=None, phases=False):
    """Three-stage packed chain.

    x_hwnc: [Nx, Mx, B, Cin4] (HWNC), or with ``phases`` the packed
    producer [Hg, Wg, B, 4·Cin4] whose fine grid is interleaved at load
    time; k1 [2,2,Cin4,C4], k2/k3 [2,2,C4,C4]; b* group-tiled [C4].
    ``pre_act``: x is a raw producer output whose leaky_relu(0.2) is
    applied here; ``pre_bias`` [Cin4]: its deferred bias, added first.
    Returns g3 [Nx+1, Mx+1, B, C4] (HWNC view of a BHWC tensor).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (three stage launches, counted as one call) or raises."""
    if x_hwnc.device.type == "cpu":
        return packed_g123_plain(x_hwnc, k1, b1, k2, b2, k3, b3, pre_act,
                                 pre_bias, phases)
    fn = _build.load("packed_chain")
    if phases:
        hg, wg, b, c4g = x_hwnc.shape
        nx, mx, cin4 = 2 * (hg - 1), 2 * (wg - 1), c4g // 4
    else:
        nx, mx, b, cin4 = x_hwnc.shape
    c4 = k1.shape[3]
    if x_hwnc.stride(3) != 1 or cin4 % 16 or c4 % 16:
        raise ValueError(f"x {tuple(x_hwnc.shape)} strides {x_hwnc.stride()}: "
                         "channels must be contiguous and multiples of 16")
    if pre_bias is not None and not pre_act:
        raise ValueError("pre_bias requires pre_act")
    dt, dev = x_hwnc.dtype, x_hwnc.device
    ks = [k.to(dt).contiguous() for k in (k1, k2, k3)]
    bs = [v.to(dt).contiguous() for v in (b1, b2, b3)]
    pb = None if pre_bias is None else pre_bias.to(dt).contiguous()
    n, m = nx + 1, mx + 1
    g1, g2, g3 = (torch.empty((b, n, m, c4), dtype=dt, device=dev)
                  for _ in range(3))
    xs = (x_hwnc.stride(0), x_hwnc.stride(1), x_hwnc.stride(2))
    gs = (g1.stride(1), g1.stride(2), g1.stride(0))
    _stage(fn, dt, x_hwnc, xs, nx, mx, n, m, b, cin4, phases, pb, pre_act,
           ks[0], bs[0], 1, g1, None, 1, 1)
    _stage(fn, dt, g1, gs, n, m, n, m, b, c4, False, None, False,
           ks[1], bs[1], 0, g2, None, 0, 0)
    _stage(fn, dt, g2, gs, n, m, n, m, b, c4, False, None, False,
           ks[2], bs[2], 1, g3, g1, 0, 1)
    packed_g123.launches += 1
    return g3.permute(1, 2, 0, 3)


packed_g123.launches = 0
