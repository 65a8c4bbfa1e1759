"""The port's kernel modules against the JAX package's twins (CPU, fp32).

On the CPU each wrapper runs its plain PyTorch version, and so does the
JAX function (its Pallas kernel falls back to the jnp twin off the TPU).
Same numpy inputs into both; tolerance 1e-5 max abs, and exact for the
pure data movement of ``output_stage_x8`` and ``output_stage`` (also in
bf16 at clamp bounds that bf16 rounds, and ``output_stage_x8`` against its
Pallas kernel in interpret mode);
``style_dot_hwbm``, ``fused_in_mod``, ``fused_o_branch`` (bf16),
``fused_modulation`` and ``fused_tail`` are also held against their Pallas
kernels in interpret mode, and ``mid_shuffle`` with its gradient exactly;
the options ``packed_g123(k4, b4)`` and ``style_blend_dot(hwbc=True)``
against JAX's twins, its Pallas kernels in interpret mode (at
``tests/test_kernels.py``'s tolerances) and JAX's VJPs.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.

Also here: a wrapper given a tensor that lies on a CUDA device launches
the kernel or raises — it never falls back to the plain version — and the
launch and route counters stay 0 on the CPU; the rules that route
``head_dot``, ``fused_tail``, ``style_dot_hwbm``, ``style_blend_dot``,
``packed_g123``, ``mid_shuffle``, ``fused_o_branch``,
``fused_modulation``, ``in_stats``, ``fused_in_mod``, ``output_stage_x8``
and ``output_stage`` between their kernels; the chunk plan of the
statistics kernels; the weight arrangement of the five ``wgmma`` routes
(and of v for ``fused_modulation``'s); and the argument counts of the exported C functions against their
``ctypes`` signatures.
"""

import ast
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# modules by name: a package may export a function under a module's name
jax_fim = importlib.import_module("endosr.kernels.fused_in_mod")
jax_fm = importlib.import_module("endosr.kernels.fused_mod")
jax_fo = importlib.import_module("endosr.kernels.fused_obranch")
jax_ft = importlib.import_module("endosr.kernels.fused_tail")
jax_sm = importlib.import_module("endosr.kernels.shuffle_mid")
jax_hd = importlib.import_module("endosr.kernels.head_dot")
jax_os = importlib.import_module("endosr.kernels.output_stage")
jax_pc = importlib.import_module("endosr.kernels.packed_chain")
jax_sd = importlib.import_module("endosr.kernels.style_dot")
t_fim = importlib.import_module("endosr_torch.kernels.fused_in_mod")
t_fm = importlib.import_module("endosr_torch.kernels.fused_mod")
t_fo = importlib.import_module("endosr_torch.kernels.fused_obranch")
t_ft = importlib.import_module("endosr_torch.kernels.fused_tail")
t_sm = importlib.import_module("endosr_torch.kernels.shuffle_mid")
t_hd = importlib.import_module("endosr_torch.kernels.head_dot")
t_is = importlib.import_module("endosr_torch.kernels.in_stats")
t_os = importlib.import_module("endosr_torch.kernels.output_stage")
t_pc = importlib.import_module("endosr_torch.kernels.packed_chain")
t_sd = importlib.import_module("endosr_torch.kernels.style_dot")
t_build = importlib.import_module("endosr_torch.kernels._build")

TOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _cmp(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max |Δ| {err:.3g} > {tol}"


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- packed_g123

@pytest.mark.parametrize("mode,nx,mx,b,cin4,c4", [
    ("phases", 8, 10, 2, 16, 16),
    ("pre_act", 8, 10, 2, 16, 16),
    ("phases", 14, 22, 3, 16, 16),
    ("pre_act", 13, 21, 3, 16, 16),
    ("phases", 14, 22, 3, 64, 128),
    ("pre_act", 13, 21, 3, 64, 128),
], ids=["phases+pre_act+pre_bias", "pre_act",
        "phases+pre_act+pre_bias-14x22-b3-c16",
        "pre_act-13x21-b3-c16", "phases+pre_act+pre_bias-14x22-b3-c64-c4_128",
        "pre_act-13x21-b3-c64-c4_128"])
def test_packed_g123_matches_jax_twin(mode, nx, mx, b, cin4, c4):
    """Also at odd extents (an output of 14 × 22 or 15 × 23, no tile of
    the card's kernels fills it) and at the ``wgmma`` route's channels."""
    rng = _rng(3)
    s1, s2 = 0.8 / np.sqrt(4 * cin4), 0.8 / np.sqrt(4 * c4)
    k1 = _f32(rng, 2, 2, cin4, c4, s=s1)
    k2, k3 = _f32(rng, 2, 2, c4, c4, s=s2), _f32(rng, 2, 2, c4, c4, s=s2)
    b1, b2, b3 = (_f32(rng, c4, s=0.1) for _ in range(3))
    if mode == "pre_act":
        x = _f32(rng, nx, mx, b, cin4, s=0.5)
        want = jax_pc.packed_g123_reference(
            jnp.asarray(x), k1, b1, k2, b2, k3, b3, pre_act=True)
        got = t_pc.packed_g123(_t(x), *map(_t, (k1, b1, k2, b2, k3, b3)),
                               pre_act=True)
    else:
        hg, wg = nx // 2 + 1, mx // 2 + 1
        g4 = _f32(rng, hg, wg, b, 4 * cin4, s=0.5)
        g4[hg - 1] = 9.0      # the dead row and column the interleave drops
        g4[:, wg - 1] = -9.0
        pb = _f32(rng, cin4, s=0.1)
        want = jax_pc.packed_g123_reference(
            jax_pc.unfold_g4_phases(jnp.asarray(g4)), k1, b1, k2, b2, k3, b3,
            pre_act=True, pre_bias=jnp.asarray(pb))
        got = t_pc.packed_g123(_t(g4), *map(_t, (k1, b1, k2, b2, k3, b3)),
                               pre_act=True, pre_bias=_t(pb), phases=True)
    assert got.shape == (nx + 1, mx + 1, b, c4)
    _cmp(got.numpy(), want)


def _k4_operands(rng, nx=13, mx=11, b=2, cin4=32, c4=32, c4o=48):
    s1, s2 = 0.8 / np.sqrt(4 * cin4), 0.8 / np.sqrt(4 * c4)
    return (_f32(rng, nx, mx, b, cin4, s=0.5),
            _f32(rng, 2, 2, cin4, c4, s=s1), _f32(rng, c4, s=0.1),
            _f32(rng, 2, 2, c4, c4, s=s2), _f32(rng, c4, s=0.1),
            _f32(rng, 2, 2, c4, c4, s=s2), _f32(rng, c4, s=0.1),
            _f32(rng, 2, 2, c4, c4o, s=s2), _f32(rng, c4o, s=0.1))


def test_packed_g123_stage4_matches_jax_twin_and_kernel():
    """``k4``/``b4``, the absorbed ungated stage 4: the plain version
    against JAX's twin (1e-5) and JAX's Pallas kernel in interpret mode
    (``tests/test_kernels.py``'s 2e-3), C4out ≠ C4, odd extents."""
    ops = _k4_operands(_rng(21))
    got = t_pc.packed_g123(*map(_t, ops[:7]), pre_act=True, k4=_t(ops[7]),
                           b4=_t(ops[8]))
    want = jax_pc.packed_g123_reference(*map(jnp.asarray, ops), pre_act=True)
    assert got.shape == (14, 12, 2, 48)
    _cmp(got.numpy(), want)
    kern = jax_pc._forward(*map(jnp.asarray, ops), True, interpret=True)
    _cmp(got.numpy(), kern, 2e-3)


def test_packed_g123_stage4_vjp_matches_jax():
    """The ``k4`` VJP (JAX's ``_bwd``, ``packed_chain.py:486-493``): every
    operand's gradient, through the wrapper under autograd and through
    :func:`packed_g123_vjp`, against JAX's ``jax.vjp`` of ``packed_g123``
    (1e-5 relative to the largest entry; JAX's test bar is 5e-2)."""
    import jax

    rng = _rng(22)
    ops = _k4_operands(rng)
    gout = _f32(rng, 14, 12, 2, 48)
    _, vjp = jax.vjp(lambda *a: jax_pc.packed_g123(*a, pre_act=True),
                     *map(jnp.asarray, ops))
    want = vjp(jnp.asarray(gout))
    ts = [_t(a).requires_grad_(True) for a in ops]
    out = t_pc.packed_g123(*ts[:7], pre_act=True, k4=ts[7], b4=ts[8])
    out.backward(_t(gout))
    direct = t_pc.packed_g123_vjp(*map(_t, ops[:7]), None, _t(gout),
                                  pre_act=True, k4=_t(ops[7]), b4=_t(ops[8]))
    assert direct[7] is None and len(direct) == 10
    for i, w in enumerate(want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-12)
        for got in (ts[i].grad, direct[i if i < 7 else i + 1]):
            assert float(np.abs(got.numpy() - w).max()) <= 1e-5 * scale, i


def test_unfold_g4_phases_matches_jax():
    g4 = _f32(_rng(4), 5, 6, 2, 12)
    _cmp(t_pc.unfold_g4_phases(_t(g4)).numpy(),
         jax_pc.unfold_g4_phases(jnp.asarray(g4)), 0.0)


_UP1_STRIDES = (128 * 8 * 256, 8 * 256, 256, 1)      # x [128,128,8,256] HWNC
_PACKED_STRIDES = (129 * 512, 512, 129 * 129 * 512, 1)   # HWNC of [8,129,129,512]


@pytest.mark.parametrize("dtype,cin4,c4,strides,ptr,want", [
    (torch.bfloat16, 256, 128, _UP1_STRIDES, 0, "wgmma"),
    (torch.bfloat16, 128, 128, _PACKED_STRIDES, 4096, "wgmma"),
    (torch.bfloat16, 64, 128, (21 * 3 * 64, 3 * 64, 64, 1), 0, "wgmma"),
    (torch.float32, 256, 128, _UP1_STRIDES, 0, "fp32"),
    (torch.float32, 16, 16, (10 * 2 * 16, 2 * 16, 16, 1), 0, "fp32"),
    (torch.bfloat16, 16, 16, (10 * 2 * 16, 2 * 16, 16, 1), 0, "mma"),
    (torch.bfloat16, 96, 128, (128 * 8 * 96, 8 * 96, 96, 1), 0, "mma"),
    (torch.bfloat16, 256, 64, _UP1_STRIDES, 0, "mma"),
    (torch.bfloat16, 256, 128, (128 * 8 * 260, 8 * 260, 260, 1), 0, "mma"),
    (torch.bfloat16, 256, 128, _UP1_STRIDES, 8, "mma"),
    (torch.bfloat16, 256, 128, (1, 128, 128 * 128, 128 * 128 * 8), 0, "mma"),
], ids=["up1", "tail_phases", "ragged_c64", "fp32", "fp32_small", "c16",
        "cin_96", "c4_64", "stride_not_16_bytes", "base_not_16_bytes",
        "channels_not_contiguous"])
def test_packed_g123_route(dtype, cin4, c4, strides, ptr, want):
    assert t_pc.packed_g123_route(dtype, cin4, c4, strides, ptr) == want


@pytest.mark.parametrize("cin", [64, 256])
def test_packed_stage_packed_weights_round_trip_and_convolve(cin):
    """The ``wgmma`` stage's weight order: [slice, tap, o, c] tiles of all
    128 output channels whose 16-byte pieces are swizzled. Unpacking gives k
    back, a chain with the unpacked weights equals ``packed_g123_plain``
    exactly, and a tile read the way the kernel's descriptor reads it
    (piece ^ (o & 7)) is the [o, c] slice of the tap."""
    rng = _rng(60 + cin)
    k1 = _t(_f32(rng, 2, 2, cin, 128, s=0.05))
    packed = t_pc.packed_stage_pack_weights(k1)
    assert packed.shape == (cin // 64, 4, 128, 64) and packed.is_contiguous()
    back = t_pc.packed_stage_unpack_weights(packed)
    assert torch.equal(back, k1)
    s, tap, o = cin // 64 - 1, 2, 93
    row = packed[s, tap, o].reshape(8, 8)
    logical = torch.stack([row[j ^ (o & 7)] for j in range(8)]).reshape(64)
    assert torch.equal(logical, k1[tap // 2, tap % 2, s * 64:(s + 1) * 64, o])
    x = _t(_f32(rng, 5, 7, 2, cin))
    k2, k3 = (_t(_f32(rng, 2, 2, 128, 128, s=0.05)) for _ in range(2))
    bs = [_t(_f32(rng, 128, s=0.1)) for _ in range(3)]
    assert torch.equal(
        t_pc.packed_g123_plain(x, back, bs[0], k2, bs[1], k3, bs[2], True),
        t_pc.packed_g123_plain(x, k1, bs[0], k2, bs[1], k3, bs[2], True))
    with pytest.raises(ValueError, match="64"):
        t_pc.packed_stage_pack_weights(torch.zeros(2, 2, 48, 128))


# ----------------------------------------------------------- style_blend_dot

@pytest.mark.parametrize("blocks", [2, 1], ids=["group_of_2", "group_of_1"])
def test_style_blend_dot_matches_jax_twin(blocks):
    """Two style groups of uneven size, as the flagship's 7 + 6."""
    rng = _rng(5 + blocks)
    b, h, w, j, c2 = 2, 8, 8, 36, 16
    n = 2 * blocks
    sh = (rng.random((b, h, w, j)) > 0.7).astype(np.float32)
    v = _f32(rng, b, j, n * c2, s=0.3)
    convs = [_f32(rng, h, w, b, c2) for _ in range(n)]
    bias = _f32(rng, n * c2, s=0.1)
    want = jax_sd.style_blend_reference(jnp.asarray(sh), jnp.asarray(v),
                                        tuple(map(jnp.asarray, convs)),
                                        jnp.asarray(bias))
    got = t_sd.style_blend_dot(_t(sh), _t(v), tuple(map(_t, convs)), _t(bias))
    _cmp(got.numpy(), want)


def test_style_blend_dot_hwbc_matches_jax_twin_kernel_and_vjp():
    """``hwbc=True``: ``shifted`` as [H,W,B,J]. The plain version equals
    the [B,H,W,J] call exactly and JAX's twin to 1e-5; JAX's Pallas kernel
    in interpret mode within ``tests/test_kernels.py``'s 2e-5; the VJP
    (g_shifted back in [H,W,B,J]) against JAX's ``jax.vjp`` of
    ``style_blend_dot(hwbc=True)`` to 1e-5 relative (JAX's bar: 1e-3)."""
    import jax

    rng = _rng(23)
    b, h, w, j, c2, n = 2, 8, 8, 36, 64, 4
    sh = (rng.random((b, h, w, j)) > 0.7).astype(np.float32)
    sh_h = np.ascontiguousarray(sh.transpose(1, 2, 0, 3))
    v = _f32(rng, b, j, n * c2, s=0.3)
    convs = [_f32(rng, h, w, b, c2) for _ in range(n)]
    bias = _f32(rng, n * c2, s=0.1)
    jconvs = tuple(map(jnp.asarray, convs))
    got = t_sd.style_blend_dot(_t(sh_h), _t(v), tuple(map(_t, convs)),
                               _t(bias), hwbc=True)
    flat = t_sd.style_blend_dot(_t(sh), _t(v), tuple(map(_t, convs)), _t(bias))
    assert torch.equal(got, flat)
    _cmp(got.numpy(), jax_sd.style_blend_reference(
        jnp.asarray(sh_h), jnp.asarray(v), jconvs, jnp.asarray(bias), True))
    _cmp(got.numpy(), jax_sd._blend_forward(
        jnp.asarray(sh_h), jnp.asarray(v), jconvs, jnp.asarray(bias),
        hwbc=True, interpret=True), 2e-5)
    gout = _f32(rng, h, w, b, n * c2)
    _, vjp = jax.vjp(lambda s, vv, cs, bb: jax_sd.style_blend_dot(
        s, vv, cs, bb, True), jnp.asarray(sh_h), jnp.asarray(v), jconvs,
        jnp.asarray(bias))
    want = jax.tree.leaves(vjp(jnp.asarray(gout)))
    ts = [_t(a).requires_grad_(True) for a in (sh_h, v, *convs, bias)]
    t_sd.style_blend_dot(ts[0], ts[1], tuple(ts[2:-1]), ts[-1],
                         hwbc=True).backward(_t(gout))
    assert ts[0].grad.shape == (h, w, b, j)
    for t, w_ in zip(ts, want):
        w_ = np.asarray(w_)
        scale = max(float(np.abs(w_).max()), 1e-12)
        assert float(np.abs(t.grad.numpy() - w_).max()) <= 1e-5 * scale


def test_style_blend_dot_matches_jax_twin_with_tiles_across_convs():
    """c2 = 24, M = 264: a 128-channel tile of the ``tc`` route spans
    several convs, so its table index is per 8-channel piece."""
    rng = _rng(9)
    b, h, w, j, c2, n = 2, 5, 7, 90, 24, 11
    sh = (rng.random((b, h, w, j)) > 0.7).astype(np.float32)
    v = _f32(rng, b, j, n * c2, s=0.3)
    convs = [_f32(rng, h, w, b, c2) for _ in range(n)]
    bias = _f32(rng, n * c2, s=0.1)
    want = jax_sd.style_blend_reference(jnp.asarray(sh), jnp.asarray(v),
                                        tuple(map(jnp.asarray, convs)),
                                        jnp.asarray(bias))
    got = t_sd.style_blend_dot(_t(sh), _t(v), tuple(map(_t, convs)), _t(bias))
    assert got.shape == (h, w, b, n * c2)
    _cmp(got.numpy(), want)


_CONV_STRIDES = (128 * 8 * 128, 8 * 128, 128, 1)    # [H,W,B,c2] view of BHWC


@pytest.mark.parametrize("dtype,j,m,c2,strides,aligned,want", [
    (torch.bfloat16, 90, 1792, 128, (128 * 128, 128, 128 * 128 * 128, 1), True,
     "tc"),
    (torch.bfloat16, 90, 1536, 128, _CONV_STRIDES, True, "tc"),
    (torch.bfloat16, 90, 264, 24, (21 * 24, 24, 13 * 21 * 24, 1), True, "tc"),
    (torch.float32, 90, 1792, 128, _CONV_STRIDES, True, "cuda_core"),
    (torch.bfloat16, 90, 1792, 128, _CONV_STRIDES, False, "cuda_core"),
    (torch.bfloat16, 90, 180, 20, (21 * 20, 20, 13 * 21 * 20, 1), True,
     "cuda_core"),
    (torch.bfloat16, 90, 264, 24, (21 * 26, 26, 13 * 21 * 26, 1), True,
     "cuda_core"),
    (torch.bfloat16, 90, 264, 24, (1, 13 * 24, 24, 13 * 21 * 24), True,
     "cuda_core"),
    (torch.bfloat16, 100, 1792, 128, _CONV_STRIDES, True, "cuda_core"),
    (torch.bfloat16, 89, 1792, 128, _CONV_STRIDES, True, "cuda_core"),
], ids=["flagship_7", "flagship_6", "ragged_c2_24", "fp32", "unaligned_conv",
        "c2_20", "conv_stride_not_16_bytes", "channels_not_contiguous", "j100",
        "j_odd"])
def test_style_blend_route(dtype, j, m, c2, strides, aligned, want):
    assert t_sd.style_blend_route(dtype, j, m, c2, strides, aligned) == want


# ------------------------------------------------------------------ head_dot

@pytest.mark.parametrize("pre_bias", [True, False], ids=["pre_bias", "raw"])
def test_head_dot_matches_jax_twin(pre_bias):
    """``wout`` smaller than the padded width: the dead column and the pad
    columns are gated."""
    rng = _rng(7)
    hp, wc, b, c4, cout, wout = 9, 16, 2, 32, 64, 12
    g4 = _f32(rng, hp, wc, b, c4)
    w64 = _f32(rng, 3, 3, c4, cout, s=0.1)
    b64 = _f32(rng, cout, s=0.1)
    pb = _f32(rng, c4, s=0.1) if pre_bias else None
    want = jax_hd.head_dot_reference(jnp.asarray(g4), jnp.asarray(w64),
                                     jnp.asarray(b64), wout,
                                     None if pb is None else jnp.asarray(pb))
    got = t_hd.head_dot(_t(g4), _t(w64), _t(b64), wout,
                        None if pb is None else _t(pb))
    assert got.shape == (hp - 1, b, wout, cout)
    _cmp(got.numpy(), want)


@pytest.mark.parametrize("pre_bias", [True, False], ids=["pre_bias", "raw"])
def test_head_dot_matches_jax_twin_ragged(pre_bias):
    """B = 3, 13×21 live pixels of 24 columns, two 64-channel slices: the
    ragged shape the card holds the ``wgmma`` kernel to."""
    rng = _rng(31)
    hp, wc, b, c4, cout, wout = 14, 24, 3, 128, 64, 21
    g4 = _f32(rng, hp, wc, b, c4, s=0.5)
    w64 = _f32(rng, 3, 3, c4, cout, s=0.03)
    b64 = _f32(rng, cout, s=0.1)
    pb = _f32(rng, c4, s=0.1) if pre_bias else None
    want = jax_hd.head_dot_reference(jnp.asarray(g4), jnp.asarray(w64),
                                     jnp.asarray(b64), wout,
                                     None if pb is None else jnp.asarray(pb))
    got = t_hd.head_dot(_t(g4), _t(w64), _t(b64), wout,
                        None if pb is None else _t(pb))
    assert got.shape == (hp - 1, b, wout, cout)
    _cmp(got.numpy(), want)


_FLAGSHIP_STRIDES = (257 * 512, 512, 257 * 257 * 512, 1)


@pytest.mark.parametrize("dtype,c4,cout,strides,want", [
    (torch.bfloat16, 512, 64, _FLAGSHIP_STRIDES, "wgmma"),
    (torch.bfloat16, 128, 64, (24 * 3 * 128, 3 * 128, 128, 1), "wgmma"),
    (torch.float32, 512, 64, _FLAGSHIP_STRIDES, "fp32"),
    (torch.bfloat16, 512, 48, _FLAGSHIP_STRIDES, "mma"),
    (torch.bfloat16, 48, 64, (257 * 48, 48, 257 * 257 * 48, 1), "mma"),
    (torch.bfloat16, 512, 64, (257 * 516, 516, 257 * 257 * 516, 1), "mma"),
    (torch.float32, 48, 48, (257 * 48, 48, 257 * 257 * 48, 1), "fp32"),
], ids=["flagship", "ragged_c128", "fp32", "cout48", "c4_48",
        "stride_not_16_bytes", "fp32_small"])
def test_head_dot_route(dtype, c4, cout, strides, want):
    assert t_hd.head_dot_route(dtype, c4, cout, strides) == want


@pytest.mark.parametrize("dtype,j,m,want", [
    (torch.bfloat16, 90, 1792, "tc"), (torch.bfloat16, 90, 1536, "tc"),
    (torch.bfloat16, 90, 264, "tc"), (torch.bfloat16, 96, 8, "tc"),
    (torch.float32, 90, 1792, "cuda_core"),
    (torch.bfloat16, 100, 1792, "cuda_core"),
    (torch.bfloat16, 90, 100, "cuda_core"),
    (torch.bfloat16, 89, 1792, "cuda_core"),
], ids=["flagship_7", "flagship_6", "ragged_m264", "j96_m8", "fp32", "j100",
        "m100", "j_odd"])
def test_style_dot_route(dtype, j, m, want):
    assert t_sd.style_dot_route(dtype, j, m) == want


@pytest.mark.parametrize("c4", [64, 192])
def test_head_dot_packed_weights_round_trip_and_convolve(c4):
    """The ``wgmma`` route's weight order: [slice, tap, o, c] tiles whose
    16-byte pieces are swizzled. Unpacking gives w64 back, a conv with the
    unpacked weights equals ``head_dot_plain`` exactly, and a tile read
    the way the kernel's descriptor reads it (piece ^ (o & 7)) is the [o, c]
    slice of the tap."""
    rng = _rng(40 + c4)
    w64 = _t(_f32(rng, 3, 3, c4, 64, s=0.1))
    packed = t_hd.head_dot_pack_weights(w64)
    assert packed.shape == (c4 // 64, 9, 64, 64) and packed.is_contiguous()
    back = t_hd.head_dot_unpack_weights(packed)
    assert torch.equal(back, w64)
    s, tap, o = c4 // 64 - 1, 5, 13
    row = packed[s, tap, o].reshape(8, 8)
    logical = torch.stack([row[j ^ (o & 7)] for j in range(8)]).reshape(64)
    assert torch.equal(logical, w64[tap // 3, tap % 3, s * 64:(s + 1) * 64, o])
    g4 = _t(_f32(rng, 6, 8, 2, c4))
    b64, pb = _t(_f32(rng, 64, s=0.1)), _t(_f32(rng, c4, s=0.1))
    assert torch.equal(t_hd.head_dot_plain(g4, back, b64, 5, pb),
                       t_hd.head_dot_plain(g4, w64, b64, 5, pb))
    with pytest.raises(ValueError, match="64"):
        t_hd.head_dot_pack_weights(torch.zeros(3, 3, 48, 64))


# ----------------------------------------------------------- output_stage_x8

@pytest.mark.parametrize("order", ["bhwc", "hbwc"])
def test_output_stage_x8_matches_jax_twin_exactly(order):
    pre = (_rng(8).standard_normal((2, 4, 8, 64)) * 0.7 + 0.5).astype(np.float32)
    if order == "hbwc":
        pre = np.ascontiguousarray(pre.transpose(1, 0, 2, 3))
    want = jax_os.output_stage_x8_reference(jnp.asarray(pre), 0.0, 1.0, order)
    got = t_os.output_stage_x8(_t(pre), 0.0, 1.0, order)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_TIGHT = (0.001, 0.999)   # both round in bf16: 0.999 is 1.0 there


def _typed(pre, dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return _t(pre).to(getattr(torch, dtype)), jnp.asarray(pre).astype(jdt)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), _TIGHT], ids=["0_1", "tight"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["bhwc", "hbwc"])
def test_output_stage_x8_matches_pallas_interpret_exactly(order, dtype, bounds):
    """The Pallas kernel itself (interpret mode) at a shape it takes
    (H % 8 == 0, W % 128 == 0), bit for bit."""
    pre = (_rng(30).standard_normal((1, 8, 128, 64)) * 0.7
           + 0.5).astype(np.float32)
    if order == "hbwc":
        pre = np.ascontiguousarray(pre.transpose(1, 0, 2, 3))
    tp, jp = _typed(pre, dtype)
    want = jax_os._forward_x8(jp, *bounds, order, interpret=True)
    got = t_os.output_stage_x8(tp, *bounds, order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["bhwc", "hbwc"])
def test_output_stage_x8_rounds_clamp_bounds_as_jax_twin(order, dtype):
    pre = (_rng(31).standard_normal((2, 4, 8, 64)) * 0.7
           + 0.5).astype(np.float32)
    if order == "hbwc":
        pre = np.ascontiguousarray(pre.transpose(1, 0, 2, 3))
    tp, jp = _typed(pre, dtype)
    want = jax_os.output_stage_x8_reference(jp, *_TIGHT, order)
    got = t_os.output_stage_x8(tp, *_TIGHT, order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # bf16 clamps to the bounds rounded to bf16: 1.0 and 0.00099945…
    top = 1.0 if dtype == "bfloat16" else np.float32(0.999)
    assert float(got.max()) == top


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_output_stage_rounds_clamp_bounds_as_jax_twin(r, dtype):
    pre = (_rng(32 + r).standard_normal((2, 4, 6, 3 * r * r)) * 0.7
           + 0.5).astype(np.float32)
    tp, jp = _typed(pre, dtype)
    want = jax_os.output_stage_reference(jp, r, *_TIGHT)
    got = t_os.output_stage(tp, r, *_TIGHT)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    top = 1.0 if dtype == "bfloat16" else np.float32(0.999)
    assert float(got.max()) == top


def _contiguous(shape):
    return torch.empty(shape, device="meta").stride()


_X8_HBWC = (256, 8, 256, 64)


@pytest.mark.parametrize("dtype,shape,strides,ptr,want", [
    (torch.bfloat16, _X8_HBWC, _contiguous(_X8_HBWC), 0, "vec16"),
    (torch.float32, _X8_HBWC, _contiguous(_X8_HBWC), 256, "vec16"),
    (torch.bfloat16, (128, 8, 128, 64), (8192, 1048576, 64, 1), 0, "vec16"),
    (torch.float32, (128, 8, 128, 64), (8192, 1048576, 64, 1), 16, "vec16"),
    (torch.bfloat16, (128, 8, 128, 64), (16384, 2097152, 128, 1), 128,
     "vec16"),
    (torch.bfloat16, _X8_HBWC, _contiguous(_X8_HBWC), 2, "v1"),
    (torch.float32, _X8_HBWC, _contiguous(_X8_HBWC), 4, "v1"),
    (torch.bfloat16, (13, 3, 21, 64), (1365, 17745, 65, 1), 2, "v1"),
    (torch.bfloat16, (13, 3, 21, 64), (1344, 17472, 64, 1), 0, "vec16"),
    (torch.bfloat16, (13, 3, 21, 64), (1346, 17472, 64, 1), 0, "v1"),
    (torch.bfloat16, (300, 256, 8, 64), _contiguous((300, 256, 8, 64)), 0,
     "v1"),
    (torch.float16, _X8_HBWC, _contiguous(_X8_HBWC), 0, "v1"),
], ids=["bf16_x8_hbwc", "fp32_x8_hbwc", "bf16_x4_bhwc_view", "fp32_x4_bhwc_view",
        "bf16_channel_slice", "bf16_base_off_16_bytes", "fp32_base_off_16_bytes",
        "bf16_pixel_stride_65", "bf16_ragged_aligned", "bf16_row_stride_odd",
        "h_times_b_over_grid", "fp16"])
def test_output_stage_x8_route(dtype, shape, strides, ptr, want):
    assert t_os.output_stage_x8_route(dtype, shape, strides, ptr) == want


@pytest.mark.parametrize("dtype,shape,r,strides,ptrs,want", [
    (torch.bfloat16, (8, 256, 256, 48), 4, None, (0, 0), "vec16"),
    (torch.float32, (8, 256, 256, 48), 4, None, (16, 0), "vec16"),
    (torch.bfloat16, (8, 128, 128, 12), 2, None, (0, 0), "vec16"),
    (torch.float32, (8, 128, 128, 12), 2, None, (0, 0), "vec16"),
    (torch.bfloat16, (8, 128, 128, 27), 3, None, (0, 0), "vec16"),
    (torch.float32, (2, 13, 20, 27), 3, None, (0, 0), "vec16"),
    (torch.bfloat16, (2, 13, 20, 27), 3, None, (0, 0), "v1"),
    (torch.float32, (2, 4, 5, 12), 2, None, (0, 0), "v1"),
    (torch.bfloat16, (8, 256, 256, 48), 4, None, (2, 0), "v1"),
    (torch.float32, (8, 256, 256, 48), 4, None, (0, 8), "v1"),
    (torch.bfloat16, (3, 13, 21, 48), 4, (17472, 1344, 64, 1), (0, 0), "v1"),
    (torch.float32, (2, 4, 8, 75), 5, None, (0, 0), "v1"),
    (torch.float32, (1, 2, 8, 512), 4, None, (0, 0), "vec16"),
    (torch.float32, (1, 2, 8, 528), 4, None, (0, 0), "v1"),
    (torch.float16, (8, 256, 256, 48), 4, None, (0, 0), "v1"),
], ids=["bf16_x8_r4", "fp32_x8_r4", "bf16_x2_r2", "fp32_x2_r2", "bf16_x3_r3",
        "fp32_r3_w20", "bf16_r3_row_stride_not_16_bytes",
        "fp32_r2_w5_rows_unaligned", "bf16_base_off_16_bytes",
        "out_base_off_16_bytes", "bf16_channel_slice", "r5",
        "fp32_span_fits", "fp32_span_too_large", "fp16"])
def test_output_stage_route(dtype, shape, r, strides, ptrs, want):
    strides = strides or _contiguous(shape)
    assert t_os.output_stage_route(dtype, shape, r, strides, ptrs) == want


def test_embed_head_channels_matches_jax_exactly():
    rng = _rng(9)
    w, b = _f32(rng, 3, 3, 8, 48), _f32(rng, 48)
    wj, bj = jax_os.embed_head_channels(jnp.asarray(w), jnp.asarray(b))
    wt, bt = t_os.embed_head_channels(_t(w), _t(b))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


# -------------------------------------------------------------- output_stage

@pytest.mark.parametrize("r,c", [(2, 3), (3, 3), (4, 3), (2, 1)],
                         ids=["r2", "r3", "r4", "r2_gray"])
def test_output_stage_matches_jax_twin_exactly(r, c):
    pre = (_rng(10 + r).standard_normal((2, 4, 6, c * r * r)) * 0.7
           + 0.5).astype(np.float32)
    want = jax_os.output_stage_reference(jnp.asarray(pre), r, 0.0, 1.0)
    got = t_os.output_stage(_t(pre), r, 0.0, 1.0)
    assert got.dtype == torch.float32 and got.shape == (2, 4 * r, 6 * r * c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_output_stage_refuses_channels_that_are_not_c_r2():
    with pytest.raises(ValueError, match="C·r²"):
        t_os.output_stage(torch.zeros(1, 4, 4, 13), 2)


# ------------------------------------------------------------ style_dot_hwbm

@pytest.mark.parametrize("b,m,against", [
    (2, 128, "pallas_interpret"), (1, 128, "pallas_interpret"),
    (3, 128, "pallas_interpret"), (2, 128, "reference"), (3, 40, "reference"),
    (2, 264, "ragged"),
], ids=["b2_kernel", "b1_kernel", "b3_kernel", "b2_twin", "b3_m40_twin",
        "b2_13x21_m264_twin"])
def test_style_dot_hwbm_matches_jax(b, m, against):
    """Odd batches and an M that is no multiple of 128 included: the port
    takes what the twin takes. The last case is the ragged shape the card
    holds the tensor-core kernel to (13×21 pixels, J = 90, dense values)."""
    rng = _rng(11 + b)
    h, w, j = (13, 21, 90) if against == "ragged" else (8, 8, 36)
    sh = (rng.random((b, h, w, j)) > 0.7).astype(np.float32)
    if against == "ragged":
        sh, against = _f32(rng, b, h, w, j, s=0.5), "reference"
    v = _f32(rng, b, j, m, s=0.3)
    if against == "reference":
        want = jax_sd.style_dot_reference(jnp.asarray(sh), jnp.asarray(v))
    else:
        want = jax_sd._forward(jnp.asarray(sh), jnp.asarray(v), interpret=True)
    got = t_sd.style_dot_hwbm(_t(sh), _t(v))
    assert got.shape == (h, w, b, m)
    _cmp(got.numpy(), want)


# ------------------------------------------------------------------ in_stats

@pytest.mark.parametrize("shape", [(2, 16, 12, 8), (1, 5, 7, 3),
                                   (2, 8, 8, 64), (3, 13, 21, 24)],
                         ids=["even", "ragged", "c64", "ragged_c24"])
def test_in_stats_matches_jnp_sums(shape):
    x = _f32(_rng(13), *shape) + 0.5
    x32 = jnp.asarray(x)
    want = (jnp.sum(x32, axis=(1, 2)), jnp.sum(x32 * x32, axis=(1, 2)))
    got = t_is.in_stats(_t(x))
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        assert g.shape == w_.shape and g.dtype == torch.float32
        rel = float(np.abs(g.numpy() - w_).max() / np.abs(w_).max())
        assert rel <= 1e-6, f"rel {rel:.3g}"


@pytest.mark.parametrize("b,hw", [(8, 128 * 128), (3, 13 * 21), (1, 1),
                                  (2, 5 * 7), (1, 128 * 128), (65535, 3)],
                         ids=["flagship", "ragged", "one_pixel", "small",
                              "one_image", "largest_b"])
@pytest.mark.parametrize("per_sm", [2, 4], ids=["vec16", "v1"])
def test_stats_plan_covers_every_pixel_once(b, hw, per_sm):
    chunks, per = t_is.stats_plan(b, hw, per_sm)
    assert per % t_is.PLAN_STEP == 0 and 1 <= chunks < 2 ** 31
    covered = np.zeros(hw, dtype=np.int64)
    for k in range(chunks):
        covered[k * per:min(hw, (k + 1) * per)] += 1
    assert (covered == 1).all()
    assert (chunks - 1) * per < hw        # no chunk is empty
    # the kernel's grid: (chunks, B) blocks, 32-bit pixel indices
    assert b <= t_is.MAX_B and chunks * per + 2048 < 2 ** 31
    if (b, hw) == (8, 128 * 128):         # about per_sm blocks an SM of 132
        assert (per_sm - 0.5) * 132 <= b * chunks <= (per_sm + 0.5) * 132


@pytest.mark.parametrize("route,per_sm", [("vec16", 2), ("v1", 4)])
@pytest.mark.parametrize("per", [None, 256, 1000], ids=["plan", "256", "1000"])
def test_chunk_plan_takes_per_or_the_routes_plan(route, per_sm, per):
    got = t_is.chunk_plan(8, 128 * 128, route, per)
    if per is None:
        assert got == t_is.stats_plan(8, 128 * 128, per_sm)
    else:
        chunks, p = got
        assert p == per and (chunks - 1) * per < 128 * 128 <= chunks * per


@pytest.mark.parametrize("dtype,c,strides,ptr,want", [
    (torch.bfloat16, 64, (1048576, 8192, 64), 0, "vec16"),
    (torch.float32, 64, (1048576, 8192, 64), 256, "vec16"),
    (torch.bfloat16, 64, (4194304, 32768, 256), 128, "vec16"),
    (torch.bfloat16, 8, (128, 32, 8), 16, "vec16"),
    (torch.bfloat16, 256, (4096, 1024, 256), 0, "vec16"),
    (torch.float32, 128, (2048, 512, 128), 0, "vec16"),
    (torch.bfloat16, 24, (6825, 525, 25), 2, "v1"),
    (torch.float32, 24, (6825, 525, 25), 4, "v1"),
    (torch.bfloat16, 24, (6552, 504, 24), 0, "v1"),
    (torch.bfloat16, 64, (1048576, 8192, 64), 8, "v1"),
    (torch.bfloat16, 64, (1048576, 8192, 68), 0, "v1"),
    (torch.bfloat16, 64, (1048580, 8192, 64), 0, "v1"),
    (torch.bfloat16, 512, (8192, 2048, 512), 0, "v1"),
    (torch.float32, 256, (4096, 1024, 256), 0, "v1"),
    (torch.bfloat16, 4, (64, 16, 4), 0, "v1"),
], ids=["bf16_c64", "fp32_c64", "bf16_channel_slice", "bf16_c8", "bf16_c256",
        "fp32_c128", "bf16_c24_unaligned", "fp32_c24_unaligned",
        "bf16_c24_three_vectors", "base_not_16_bytes", "column_stride",
        "batch_stride", "bf16_c512", "fp32_c256", "bf16_c4"])
def test_in_stats_route(dtype, c, strides, ptr, want):
    assert t_is.in_stats_route(dtype, c, strides, ptr) == want


_ALIGNED = (1048576, 8192, 64)


@pytest.mark.parametrize("dtype,c,strides,ptrs,want", [
    (torch.bfloat16, 64, (_ALIGNED, (4194304, 32768, 256), (4194304, 32768, 256)),
     (0, 128, 256, 0), "vec16"),
    (torch.float32, 64, (_ALIGNED,) * 3, (0, 0, 0, 0), "vec16"),
    (torch.bfloat16, 64, (_ALIGNED,) * 3, (0, 2, 0, 0), "v1"),
    (torch.bfloat16, 64, (_ALIGNED,) * 3, (0, 0, 0, 8), "v1"),
    (torch.bfloat16, 64, (_ALIGNED, _ALIGNED, (1048576, 8192, 66)),
     (0, 0, 0, 0), "v1"),
    (torch.bfloat16, 24, ((6552, 504, 24),) * 3, (0, 0, 0, 0), "v1"),
], ids=["bf16_channel_slices", "fp32", "gamma_unaligned", "out_unaligned",
        "beta_column_stride", "c24"])
def test_fused_in_mod_route(dtype, c, strides, ptrs, want):
    assert t_fim.fused_in_mod_route(dtype, c, strides, ptrs) == want


def test_instance_norm_kernel_stats_equal_default():
    lay = importlib.import_module("endosr_torch.nn.layers")
    x = _t(_f32(_rng(14), 2, 8, 8, 16) * 2.0 + 1.0)
    _cmp(lay.instance_norm(x, stats="kernel").numpy(),
         lay.instance_norm(x).numpy(), 1e-6)
    with pytest.raises(ValueError):
        lay.instance_norm(x, stats="variadic")


# -------------------------------------------------------------- fused_in_mod

@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (2, 8, 8, 64),
                                   (3, 13, 21, 24)],
                         ids=["c32", "c64", "ragged_c24"])
@pytest.mark.parametrize("against", ["pallas_interpret", "reference"])
def test_fused_in_mod_matches_jax(against, shape):
    rng = _rng(15)
    x = _f32(rng, *shape) * 3.0 + 1.5
    g, b = _f32(rng, *shape), _f32(rng, *shape)
    if against == "reference":
        want = jax_fim.instance_norm_modulate_reference(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    else:
        want = jax_fim.fused_instance_norm_modulate(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), interpret=True)
    got = t_fim.fused_in_mod(_t(x), _t(g), _t(b))
    _cmp(got.numpy(), want)


# ------------------------------------------------------------ fused_o_branch

def _o_operands(rng, b, h, w, n, c2):
    d = rng.random((b, h, w, 1), dtype=np.float32)
    return (d, _f32(rng, n, 9, c2, s=0.3), _f32(rng, n, c2, s=0.3),
            _f32(rng, n, 9, c2, c2, s=0.2), _f32(rng, n, c2, s=0.3))


@pytest.mark.parametrize("shape", [(2, 12, 10, 3, 16), (1, 5, 7, 2, 8)],
                         ids=["n3_c16", "ragged_n2_c8"])
def test_fused_o_branch_matches_jax_twin(shape):
    args = _o_operands(_rng(16), *shape)
    want = jax_fo.fused_o_branch_reference(*map(jnp.asarray, args))
    got = t_fo.fused_o_branch(*map(_t, args))
    _cmp(got.numpy(), want)


def test_fused_o_branch_bf16_matches_pallas_interpret():
    """bf16 at [1,32,128,1], the smallest shape the TPU kernel takes, in
    interpret mode. Both round the activation once after the ReLU; they
    differ in fp32 summation order and in the last rounding (the TPU kernel
    adds b2 before it, the twin and the port after), so ≤ 2 bf16 ulps of
    the largest value: 2⁻⁶ of it."""
    args = _o_operands(_rng(17), 1, 32, 128, 2, 16)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in args]
    want = np.asarray(jax_fo.fused_o_branch(*bf), np.float32)
    got = t_fo.fused_o_branch(*(_t(a).bfloat16() for a in args))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 32, 128, 32)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= np.abs(want).max() * 2.0 ** -6, err


def test_fused_o_branch_padding_ring_is_zero_not_relu_bias():
    """With a large positive bm, relu(bm) in conv2's padding ring would
    change every border pixel; the plain version pads after the ReLU."""
    d, wm, bm, w2, b2 = _o_operands(_rng(18), 1, 6, 6, 1, 8)
    bm = np.abs(bm) + 5.0
    got = t_fo.fused_o_branch(*map(_t, (d, wm, bm, w2, b2))).numpy()
    want = np.asarray(jax_fo.fused_o_branch_reference(
        *map(jnp.asarray, (d, wm, bm, w2, b2))))
    _cmp(got, want, 2e-5)
    actv = t_fo.o_actv_plain(_t(d), _t(wm), _t(bm), torch.float32)
    assert float(actv.min()) > 4.0       # so a wrong ring would show


_W = torch.bfloat16


@pytest.mark.parametrize("dtype,c2,ptrs,want", [
    (_W, 128, (0, 256, 4096), "wgmma"), (_W, 64, (0, 16, 32), "wgmma"),
    (_W, 32, (0, 16), "mma"), (_W, 16, (0,), "mma"),
    (torch.float32, 128, (0, 16), "fp32"), (torch.float32, 32, (8,), "fp32"),
    (_W, 128, (0, 8), "mma"),
], ids=["flagship", "c64", "c32", "c16", "fp32", "fp32_c32", "misaligned"])
def test_fused_o_branch_route(dtype, c2, ptrs, want):
    assert t_fo.fused_o_branch_route(dtype, c2, ptrs) == want


@pytest.mark.parametrize("c2", [64, 128])
def test_o_branch_packed_weights_round_trip_and_convolve(c2):
    """The ``wgmma`` route's weight order: [n, slice, tap, o, c] tiles whose
    16-byte pieces are swizzled. Unpacking gives w2 back, the plain version
    on the unpacked weights equals it on the originals exactly, and a tile
    read the way the kernel's descriptor reads it (piece ^ (o & 7)) is the
    [o, c] slice of its tap."""
    rng = _rng(50 + c2)
    d, wm, bm, w2, b2 = map(_t, _o_operands(rng, 1, 5, 6, 2, c2))
    packed = t_fo.o_branch_pack_weights(w2)
    assert packed.shape == (2, c2 // 64, 9, c2, 64) and packed.is_contiguous()
    back = t_fo.o_branch_unpack_weights(packed)
    assert torch.equal(back, w2)
    n, s, tap, o = 1, c2 // 64 - 1, 7, 21
    row = packed[n, s, tap, o].reshape(8, 8)
    logical = torch.stack([row[j ^ (o & 7)] for j in range(8)]).reshape(64)
    assert torch.equal(logical, w2[n, tap, s * 64:(s + 1) * 64, o])
    assert torch.equal(t_fo.fused_o_branch_plain(d, wm, bm, back, b2),
                       t_fo.fused_o_branch_plain(d, wm, bm, w2, b2))
    # [N, 9·2C, 2C], as fused_modulation passes it, packs the same
    assert torch.equal(t_fo.o_branch_pack_weights(w2.reshape(2, 9 * c2, c2)),
                       packed)
    with pytest.raises(ValueError, match="64"):
        t_fo.o_branch_pack_weights(torch.zeros(2, 9, 32, 32))


# ---------------------------------------------------------- fused_modulation

def _mod_operands(rng, b, h, w, k, n, c2):
    d, wm, bm, w2, bias = _o_operands(rng, b, h, w, n, c2)
    mask = (rng.random((b, h, w, k)) > 0.7).astype(np.float32)
    return (d, mask, wm, bm, w2.reshape(n, 9 * c2, c2),
            _f32(rng, b, n, 9 * k, c2, s=0.3), bias)


@pytest.mark.parametrize("against,shape", [
    ("pallas_interpret", (2, 16, 16, 10, 3, 32)),
    ("reference", (2, 16, 16, 10, 3, 32)),
    ("reference", (1, 7, 9, 4, 2, 16)),
], ids=["kernel_16x16", "twin_16x16", "twin_ragged"])
def test_fused_modulation_matches_jax(against, shape):
    args = _mod_operands(_rng(19), *shape)
    fn = (jax_fm.fused_modulation if against == "pallas_interpret"
          else jax_fm.fused_modulation_reference)
    want = fn(*map(jnp.asarray, args))
    got = t_fm.fused_modulation(*map(_t, args))
    _cmp(got.numpy(), want, 2e-5)      # sums of 9·2C + 9K products of O(1)


@pytest.mark.parametrize("dtype,c2,k,ptrs,want", [
    (_W, 128, 10, (0, 16, 32), "wgmma"), (_W, 64, 10, (0,), "wgmma"),
    (_W, 128, 16, (0,), "wgmma"), (_W, 128, 17, (0,), "mma"),
    (_W, 32, 4, (0,), "mma"), (torch.float32, 128, 10, (0,), "fp32"),
    (_W, 128, 10, (0, 16, 2), "mma"),
], ids=["flagship", "c64", "k16", "k17", "c32", "fp32", "misaligned"])
def test_fused_modulation_route(dtype, c2, k, ptrs, want):
    assert t_fm.fused_modulation_route(dtype, c2, k, ptrs) == want


@pytest.mark.parametrize("k,c2", [(10, 128), (4, 64), (16, 64)])
def test_style_packed_v_round_trip_and_tiles(k, c2):
    """v's ``wgmma`` tiles: tile u, row o holds taps 4u .. 4u+3 as k-steps
    of 16 (kk = 16·(tap % 4) + k), zero for k ≥ K and for tap ≥ 9, pieces
    swizzled. Unpacking gives v back, and the plain version on the unpacked
    v equals it on the original exactly."""
    rng = _rng(60 + k)
    args = [_t(a) for a in _mod_operands(rng, 2, 5, 6, k, 2, c2)]
    v = args[5]
    packed = t_fm.style_pack_v(v)
    assert packed.shape == (2, 2, 3, c2, 64) and packed.is_contiguous()
    back = t_fm.style_unpack_v(packed, k)
    assert torch.equal(back, v)
    b, n = 1, 1
    for u, o in ((0, 3), (1, 12), (2, c2 - 1)):
        row = packed[b, n, u, o].reshape(8, 8)
        logical = torch.stack([row[j ^ (o & 7)] for j in range(8)]).reshape(64)
        for kk in range(64):
            tap, kb = 4 * u + kk // 16, kk % 16
            want = v[b, n, tap * k + kb, o] if tap < 9 and kb < k else 0.0
            assert float(logical[kk]) == float(want)
    args2 = list(args)
    args2[5] = back
    assert torch.equal(t_fm.fused_modulation_plain(*args2),
                       t_fm.fused_modulation_plain(*args))


# ---------------------------------------------------------------- fused_tail

def _tail_operands(rng, b, hp, wc, wout, c4):
    g4 = _f32(rng, b, hp, wc, c4, s=0.1)
    g4[:, hp - 1] = 0.0                  # the gated dead row and columns
    g4[:, :, wout:] = 0.0
    return g4, _f32(rng, 3, 3, c4, 48, s=0.02), _f32(rng, 48, s=0.1) + 0.5


@pytest.mark.parametrize("layout", ["bhwc", "hwbc"])
def test_fused_tail_matches_jax_twin(layout):
    g4, wh, bh = _tail_operands(_rng(20), 2, 9, 16, 8, 32)
    want = jax_ft.fused_tail_reference(jnp.asarray(g4), jnp.asarray(wh),
                                       jnp.asarray(bh), 0.0, 1.0)
    gt = _t(g4).permute(1, 2, 0, 3) if layout == "hwbc" else _t(g4)
    got = t_ft.fused_tail(gt, _t(wh), _t(bh), 0.0, 1.0, layout)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 96)
    _cmp(got.numpy(), want)


def test_fused_tail_matches_pallas_interpret():
    g4, wh, bh = _tail_operands(_rng(21), 1, 33, 40, 32, 128)
    want = jax_ft._forward(jnp.asarray(g4), jnp.asarray(wh), jnp.asarray(bh),
                           0.0, 1.0, interpret=True)
    got = t_ft.fused_tail(_t(g4), _t(wh), _t(bh), 0.0, 1.0)
    _cmp(got.numpy(), want)


def test_fused_tail_takes_a_non_square_grid():
    """``wout`` ≠ Hp−1, which the TPU kernel refuses: equal to the head conv
    of the BHWC tensor, cropped, through ``output_stage``."""
    g4, wh, bh = _tail_operands(_rng(22), 2, 7, 12, 10, 16)
    pre = jax_hd.head_dot_reference(
        jnp.asarray(g4.transpose(1, 2, 0, 3)), jnp.asarray(wh),
        jnp.asarray(bh), 10)                                   # [h, B, 10, 48]
    want = jax_os.output_stage_reference(jnp.transpose(pre, (1, 0, 2, 3)), 4,
                                         0.0, 1.0)
    got = t_ft.fused_tail(_t(g4), _t(wh), _t(bh), 0.0, 1.0, "bhwc", 10)
    assert got.shape == (2, 24, 120)
    _cmp(got.numpy(), want)


@pytest.mark.parametrize("layout", ["bhwc", "hwbc"])
@pytest.mark.parametrize("nh,nw,padw", [(8, 8, 3), (8, 6, 2)],
                         ids=["square", "non_square"])
def test_fused_tail_with_pre_bias_matches_jax(layout, nh, nw, padw):
    """Raw g4 with the producer's bias: equal to JAX's
    ``fused_tail_reference`` fed the g4 that the JAX DepthNet activates and
    gates for it (``endosr/nn/depthnet.py``, the ``use_fused`` branch: the
    dead last row and column and the pad columns hold data here). On the
    non-square grid the reference's square crop is cut to ``wout``."""
    jl = importlib.import_module("endosr.nn.layers")
    rng = _rng(25 + nw)
    b, c4 = 2, 32
    g4 = _f32(rng, nh + 1, nw + 1 + padw, b, c4)          # HWNC, raw
    b30 = _f32(rng, c4 // 4, s=0.2)
    wh, bh = _f32(rng, 3, 3, c4, 48, s=0.05), _f32(rng, 48, s=0.1) + 0.5
    g4r = jl.leaky_relu(jnp.asarray(g4) + jnp.tile(b30, 4))
    row, _ = jl.packed_gate(nh, c4 // 4, 0, g4r.dtype)
    _, col = jl.packed_gate(nw, c4 // 4, 0, g4r.dtype)
    colw = jnp.concatenate([col, jnp.zeros((padw, col.shape[1]), col.dtype)])
    gated = g4r * row[:, None, None, :] * colw[None, :, None, :]
    want = np.asarray(jax_ft.fused_tail_reference(
        jnp.transpose(gated, (2, 0, 1, 3)), jnp.asarray(wh), jnp.asarray(bh),
        0.0, 1.0))[:, :, :12 * nw]
    gt = _t(g4) if layout == "hwbc" else _t(g4).permute(2, 0, 1, 3)
    got = t_ft.fused_tail(gt, _t(wh), _t(bh), 0.0, 1.0, layout, nw,
                          _t(np.tile(b30, 4)))
    assert got.shape == (b, 4 * nh, 12 * nw)
    _cmp(got.numpy(), want)


_TAIL_STRIDES = (257 * 512, 512, 257 * 257 * 512, 1)    # HWBC view of BHWC


@pytest.mark.parametrize("dtype,c4,strides,ptr,want", [
    (torch.bfloat16, 512, _TAIL_STRIDES, 0, "wgmma"),
    (torch.bfloat16, 128, (24 * 128, 128, 14 * 24 * 128, 1), 4096, "wgmma"),
    (torch.float32, 512, _TAIL_STRIDES, 0, "fp32"),
    (torch.bfloat16, 48, (257 * 48, 48, 257 * 257 * 48, 1), 0, "mma"),
    (torch.bfloat16, 512, (257 * 516, 516, 257 * 257 * 516, 1), 0, "mma"),
    (torch.bfloat16, 512, _TAIL_STRIDES, 8, "mma"),
    (torch.bfloat16, 512, (1, 257, 257 * 257, 257 * 257 * 8), 0, "mma"),
    (torch.float32, 48, (257 * 48, 48, 257 * 257 * 48, 1), 0, "fp32"),
], ids=["flagship", "ragged_c128", "fp32", "c4_48", "stride_not_16_bytes",
        "base_not_16_bytes", "channels_not_contiguous", "fp32_small"])
def test_fused_tail_route(dtype, c4, strides, ptr, want):
    assert t_ft.fused_tail_route(dtype, c4, strides, ptr) == want


@pytest.mark.parametrize("c4", [64, 192])
def test_fused_tail_packed_weights_round_trip_and_convolve(c4):
    """The ``wgmma`` route's weight order: [slice, tap, o, c] tiles with the
    48 output channels in i·12 + j·3 + c order and swizzled 16-byte pieces.
    Unpacking gives wh back, the unpacked weights convolve exactly like wh,
    and a tile read the way the kernel's descriptor reads it (piece ^ (o &
    7)) is the [o, c] slice of the tap for the canonical channel of slot o."""
    rng = _rng(50 + c4)
    wh = _t(_f32(rng, 3, 3, c4, 48, s=0.1))
    packed = t_ft.fused_tail_pack_weights(wh)
    assert packed.shape == (c4 // 64, 9, 48, 64) and packed.is_contiguous()
    back = t_ft.fused_tail_unpack_weights(packed)
    assert torch.equal(back, wh)
    s, tap, o = c4 // 64 - 1, 7, 29                   # slot 29: i 2, j 1, c 2
    row = packed[s, tap, o].reshape(8, 8)
    logical = torch.stack([row[j ^ (o & 7)] for j in range(8)]).reshape(64)
    assert torch.equal(logical, wh[tap // 3, tap % 3, s * 64:(s + 1) * 64,
                                   2 * 16 + 2 * 4 + 1])
    g4, bh = _t(_f32(rng, 2, 6, 9, c4)), _t(_f32(rng, 48, s=0.1))
    pb = _t(_f32(rng, c4, s=0.1))
    assert torch.equal(t_ft.fused_tail_plain(g4, back, bh, wout=7, pre_bias=pb),
                       t_ft.fused_tail_plain(g4, wh, bh, wout=7, pre_bias=pb))
    with pytest.raises(ValueError, match="64"):
        t_ft.fused_tail_pack_weights(torch.zeros(3, 3, 48, 48))


# --------------------------------------------------------------- mid_shuffle

@pytest.mark.parametrize("r,c", [(2, 128), (2, 3), (3, 4)],
                         ids=["r2_c128", "r2_c3", "r3_c4"])
def test_mid_shuffle_and_gradient_match_jax_exactly(r, c):
    import jax

    z = _f32(_rng(23), 2, 4, 6, c * r * r)
    lay = importlib.import_module("endosr.nn.layers")
    want = lay.pixel_shuffle(jnp.asarray(z), r)
    np.testing.assert_array_equal(
        np.asarray(jax_sm.mid_shuffle(jnp.asarray(z), r)), np.asarray(want))
    zt = _t(z).requires_grad_(True)
    got = t_sm.mid_shuffle(zt, r)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    wgt = _f32(_rng(24), *got.shape)
    (got * _t(wgt)).sum().backward()
    gj = jax.grad(lambda a: jnp.sum(jax_sm.mid_shuffle(a, r)
                                    * jnp.asarray(wgt)))(jnp.asarray(z))
    np.testing.assert_array_equal(zt.grad.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(
        t_sm.mid_unshuffle_plain(_t(wgt), r).numpy(), np.asarray(gj))


@pytest.mark.parametrize("esize,r,c,ptrs,want", [
    (2, 2, 128, (0, 4096), "vec16"),
    (4, 2, 128, (0, 4096), "vec16"),
    (2, 2, 8, (16, 32), "vec16"),
    (4, 2, 4, (16, 32), "vec16"),
    (2, 2, 4, (0, 0), "scalar"),
    (4, 2, 6, (0, 0), "scalar"),
    (2, 3, 128, (0, 0), "scalar"),
    (2, 2, 128, (8, 0), "scalar"),
    (4, 2, 128, (0, 4), "scalar"),
], ids=["bf16", "fp32", "bf16_c8", "fp32_c4", "bf16_c4", "fp32_c6", "r3",
        "src_not_16_bytes", "out_not_16_bytes"])
def test_mid_shuffle_route(esize, r, c, ptrs, want):
    assert t_sm.mid_shuffle_route(esize, r, c, ptrs) == want


# ------------------------------------------------------ no silent CPU fallback

class _CudaClaim:
    """Stands in for a tensor on a CUDA device (there is none here)."""

    device = torch.device("cuda")
    dtype = torch.bfloat16

    def __init__(self, shape, ptr=0):
        self.shape = torch.Size(shape)
        self.ptr = ptr

    def stride(self, dim=None):
        st = torch.empty(self.shape, device="meta").stride()
        return st if dim is None else st[dim]

    def data_ptr(self):
        return self.ptr


def _wrapper_calls():
    c = _CudaClaim
    return {
        "output_stage_x8": lambda: t_os.output_stage_x8(c((4, 2, 8, 64)),
                                                        order="hbwc"),
        "output_stage_x8[v1]": lambda: t_os.output_stage_x8(
            c((4, 2, 8, 64), ptr=2), order="hbwc"),
        "head_dot": lambda: t_hd.head_dot(
            c((9, 16, 2, 32)), torch.zeros(3, 3, 32, 64), torch.zeros(64), 8),
        "head_dot[wgmma]": lambda: t_hd.head_dot(
            c((9, 16, 2, 64)), torch.zeros(3, 3, 64, 64), torch.zeros(64), 8),
        "packed_g123": lambda: t_pc.packed_g123(
            c((8, 8, 2, 16)), *(torch.zeros(2, 2, 16, 16), torch.zeros(16)) * 3,
            pre_act=True),
        "packed_g123[wgmma]": lambda: t_pc.packed_g123(
            c((5, 5, 2, 256)), torch.zeros(2, 2, 64, 128), torch.zeros(128),
            *(torch.zeros(2, 2, 128, 128), torch.zeros(128)) * 2,
            pre_act=True, pre_bias=torch.zeros(64), phases=True),
        "style_blend_dot": lambda: t_sd.style_blend_dot(
            c((2, 4, 4, 9)), c((2, 9, 32)), (c((4, 4, 2, 16)),) * 2,
            torch.zeros(32)),
        "style_blend_dot[tc]": lambda: t_sd.style_blend_dot(
            c((2, 4, 4, 90)), c((2, 90, 32)), (c((4, 4, 2, 16)),) * 2,
            torch.zeros(32)),
        "output_stage": lambda: t_os.output_stage(c((2, 4, 8, 12)), 2),
        "output_stage[v1]": lambda: t_os.output_stage(c((2, 4, 8, 12), ptr=2),
                                                      2),
        "style_dot_hwbm": lambda: t_sd.style_dot_hwbm(c((2, 4, 4, 9)),
                                                      c((2, 9, 32))),
        "style_dot_hwbm[tc]": lambda: t_sd.style_dot_hwbm(c((2, 4, 4, 90)),
                                                          c((2, 90, 32))),
        "in_stats": lambda: t_is.in_stats(c((2, 4, 4, 8))),
        "in_stats[v1]": lambda: t_is.in_stats(c((3, 13, 21, 24))),
        "fused_in_mod": lambda: t_fim.fused_in_mod(*(c((2, 4, 4, 8)),) * 3),
        "fused_in_mod[v1]": lambda: t_fim.fused_in_mod(
            *(c((3, 13, 21, 24)),) * 3),
        "fused_o_branch": lambda: t_fo.fused_o_branch(
            c((2, 4, 4, 1)), *_zero_o_weights()),
        "fused_modulation": lambda: t_fm.fused_modulation(
            c((2, 4, 4, 1)), c((2, 4, 4, 3)), *_zero_o_weights()[:2],
            torch.zeros(2, 144, 16), torch.zeros(2, 2, 27, 16),
            torch.zeros(2, 16)),
        "fused_o_branch[wgmma]": lambda: t_fo.fused_o_branch(
            c((2, 4, 4, 1)), *_zero_o_weights(128)),
        "fused_modulation[wgmma]": lambda: t_fm.fused_modulation(
            c((2, 4, 4, 1)), c((2, 4, 4, 10)), *_zero_o_weights(64)[:2],
            torch.zeros(2, 9 * 64, 64), torch.zeros(2, 2, 90, 64),
            torch.zeros(2, 64)),
        "fused_tail": lambda: t_ft.fused_tail(
            c((2, 9, 16, 32)), torch.zeros(3, 3, 32, 48), torch.zeros(48)),
        "fused_tail[wgmma]": lambda: t_ft.fused_tail(
            c((9, 16, 2, 64)), torch.zeros(3, 3, 64, 48), torch.zeros(48),
            layout="hwbc", wout=8, pre_bias=torch.zeros(64)),
        "mid_shuffle": lambda: t_sm.mid_shuffle(c((2, 4, 4, 16)), 2),
        "mid_shuffle[scalar]": lambda: t_sm.mid_shuffle(c((2, 4, 4, 12)), 2),
    }


def _zero_o_weights(c2=16):
    return (torch.zeros(2, 9, c2), torch.zeros(2, c2),
            torch.zeros(2, 9, c2, c2), torch.zeros(2, c2))


@pytest.mark.parametrize("name", ["output_stage_x8", "output_stage_x8[v1]",
                                  "head_dot",
                                  "head_dot[wgmma]",
                                  "packed_g123", "packed_g123[wgmma]",
                                  "style_blend_dot",
                                  "style_blend_dot[tc]",
                                  "output_stage", "output_stage[v1]",
                                  "style_dot_hwbm",
                                  "style_dot_hwbm[tc]",
                                  "in_stats", "in_stats[v1]",
                                  "fused_in_mod", "fused_in_mod[v1]",
                                  "fused_o_branch", "fused_modulation",
                                  "fused_o_branch[wgmma]",
                                  "fused_modulation[wgmma]",
                                  "fused_tail", "fused_tail[wgmma]",
                                  "mid_shuffle", "mid_shuffle[scalar]"])
def test_wrapper_on_cuda_tensor_raises_without_kernel(name, monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr("endosr_torch.kernels._build.os.path.exists",
                        lambda p: False)
    routed = (t_hd.head_dot, t_sd.style_dot_hwbm, t_ft.fused_tail,
              t_sd.style_blend_dot, t_pc.packed_g123, t_sm.mid_shuffle,
              t_fo.fused_o_branch, t_fm.fused_modulation, t_is.in_stats,
              t_fim.fused_in_mod, t_os.output_stage_x8, t_os.output_stage)
    before = [dict(f.routes) for f in routed]
    # no nvcc here: the wrapper must fail to build, not run the plain version
    # (on any route of the routed kernels), and count nothing
    with pytest.raises(RuntimeError, match="nvcc"):
        _wrapper_calls()[name]()
    assert [f.routes for f in routed] == before


def test_cpu_calls_leave_launch_counters_at_zero():
    fns = (t_os.output_stage_x8, t_hd.head_dot, t_pc.packed_g123,
           t_sd.style_blend_dot, t_os.output_stage, t_sd.style_dot_hwbm,
           t_is.in_stats, t_fim.fused_in_mod, t_fo.fused_o_branch,
           t_fm.fused_modulation, t_ft.fused_tail, t_sm.mid_shuffle)
    before = [f.launches for f in fns]
    t_os.output_stage_x8(torch.zeros(1, 8, 8, 64))
    t_hd.head_dot(torch.zeros(9, 9, 1, 16), torch.zeros(3, 3, 16, 64),
                  torch.zeros(64))
    t_pc.packed_g123(torch.zeros(4, 4, 1, 16),
                     *(torch.zeros(2, 2, 16, 16), torch.zeros(16)) * 3)
    t_sd.style_blend_dot(torch.zeros(1, 4, 4, 9), torch.zeros(1, 9, 32),
                         (torch.zeros(4, 4, 1, 16),) * 2, torch.zeros(32))
    t_os.output_stage(torch.zeros(1, 4, 4, 12), 2)
    t_sd.style_dot_hwbm(torch.zeros(1, 4, 4, 9), torch.zeros(1, 9, 32))
    t_is.in_stats(torch.zeros(1, 4, 4, 8))
    t_fim.fused_in_mod(*(torch.zeros(1, 4, 4, 8),) * 3)
    t_fo.fused_o_branch(torch.zeros(2, 4, 4, 1), *_zero_o_weights())
    t_fm.fused_modulation(torch.zeros(2, 4, 4, 1), torch.zeros(2, 4, 4, 3),
                          *_zero_o_weights()[:2], torch.zeros(2, 144, 16),
                          torch.zeros(2, 2, 27, 16), torch.zeros(2, 16))
    t_ft.fused_tail(torch.zeros(2, 9, 16, 32), torch.zeros(3, 3, 32, 48),
                    torch.zeros(48))
    t_sm.mid_shuffle(torch.zeros(2, 4, 4, 16), 2)
    # shapes the card would send down the tensor-core routes
    t_hd.head_dot(torch.zeros(5, 5, 1, 64, dtype=torch.bfloat16),
                  torch.zeros(3, 3, 64, 64), torch.zeros(64))
    t_sd.style_dot_hwbm(torch.zeros(1, 4, 4, 90, dtype=torch.bfloat16),
                        torch.zeros(1, 90, 32, dtype=torch.bfloat16))
    t_ft.fused_tail(torch.zeros(9, 16, 2, 64, dtype=torch.bfloat16),
                    torch.zeros(3, 3, 64, 48), torch.zeros(48), layout="hwbc",
                    wout=8, pre_bias=torch.zeros(64))
    t_sd.style_blend_dot(torch.zeros(1, 4, 4, 90, dtype=torch.bfloat16),
                         torch.zeros(1, 90, 32, dtype=torch.bfloat16),
                         (torch.zeros(4, 4, 1, 16, dtype=torch.bfloat16),) * 2,
                         torch.zeros(32))
    t_pc.packed_g123(torch.zeros(3, 3, 1, 256, dtype=torch.bfloat16),
                     torch.zeros(2, 2, 64, 128), torch.zeros(128),
                     *(torch.zeros(2, 2, 128, 128), torch.zeros(128)) * 2,
                     pre_act=True, pre_bias=torch.zeros(64), phases=True)
    t_sm.mid_shuffle(torch.zeros(1, 2, 2, 512, dtype=torch.bfloat16), 2)
    t_fo.fused_o_branch(torch.zeros(1, 4, 4, 1, dtype=torch.bfloat16),
                        *_zero_o_weights(64))
    t_fm.fused_modulation(torch.zeros(1, 4, 4, 1, dtype=torch.bfloat16),
                          torch.zeros(1, 4, 4, 10, dtype=torch.bfloat16),
                          *_zero_o_weights(64)[:2], torch.zeros(2, 576, 64),
                          torch.zeros(1, 2, 90, 64), torch.zeros(2, 64))
    t_os.output_stage_x8(torch.zeros(8, 1, 8, 64, dtype=torch.bfloat16),
                         0.001, 0.999, "hbwc")
    t_os.output_stage(torch.zeros(1, 4, 8, 27, dtype=torch.bfloat16), 3)
    assert [f.launches for f in fns] == before == [0] * 12
    assert t_hd.head_dot.routes == {"wgmma": 0, "mma": 0, "fp32": 0}
    assert t_sd.style_dot_hwbm.routes == {"tc": 0, "cuda_core": 0}
    assert t_ft.fused_tail.routes == {"wgmma": 0, "mma": 0, "fp32": 0}
    assert t_sd.style_blend_dot.routes == {"tc": 0, "cuda_core": 0,
                                           "tc_hwbc": 0, "cuda_core_hwbc": 0}
    assert t_pc.packed_g123.routes == {"wgmma": 0, "mma": 0, "fp32": 0,
                                       "k4_mma": 0, "k4_fp32": 0}
    assert t_sm.mid_shuffle.routes == {"vec16": 0, "scalar": 0}
    assert t_fo.fused_o_branch.routes == {"wgmma": 0, "mma": 0, "fp32": 0}
    assert t_fm.fused_modulation.routes == {"wgmma": 0, "mma": 0, "fp32": 0}
    assert t_is.in_stats.routes == {"vec16": 0, "v1": 0}
    assert t_fim.fused_in_mod.routes == {"vec16": 0, "v1": 0}
    assert t_os.output_stage_x8.routes == {"vec16": 0, "v1": 0}
    assert t_os.output_stage.routes == {"vec16": 0, "v1": 0}


# ------------------------------------------------------- exported C signatures

def _exported_functions():
    return [(lib, fn) for lib, fns in t_build.SOURCES.items() for fn in fns]


@pytest.mark.parametrize("lib,fn", _exported_functions(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_exported_function_takes_as_many_arguments_as_its_argtypes(lib, fn):
    """A mismatch between an ``extern "C"`` function and its ``ctypes``
    argument list would otherwise only show on the card."""
    src = (REPO / "endosr_torch" / "csrc" / f"{lib}.cu").read_text()
    externs = src[src.index('extern "C" {'):]
    found = re.findall(r"\bint\s+" + re.escape(fn) + r"\s*\(([^)]*)\)\s*\{",
                       externs)
    assert len(found) == 1, f"{fn}: {len(found)} definitions in {lib}.cu"
    params = [p for p in found[0].split(",") if p.strip()]
    assert len(params) == len(t_build.SOURCES[lib][fn])
    # pointers are c_void_p, i64 is c_longlong, float is c_float, the rest int
    kinds = {t_build.P: "*", t_build.I64: "i64 ", t_build.F32: "float ",
             t_build.I: "int "}
    for param, ctype in zip(params, t_build.SOURCES[lib][fn]):
        param = " ".join(param.split())
        if ctype is t_build.P:
            assert "*" in param, f"{fn}: {param!r} bound as a pointer"
        else:
            assert "*" not in param and param.startswith(kinds[ctype]), \
                f"{fn}: {param!r} bound as {ctype.__name__}"


# -------------------------------------------------------------- import rule

_FORBIDDEN = ("jax", "flax", "optax", "endosr")


def _port_files():
    return sorted((REPO / "endosr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_or_reference_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in _FORBIDDEN, f"{path.name} imports {mod}"
