"""The serving precisions ``mixed``, ``bf16c`` and ``bf16c3`` of the port
against the JAX package, on the CPU.

- ``centered_conv`` against ``endosr.nn.layers.centered_conv`` (3×3, SAME,
  1, 2 and 3 passes, with and without a bias; the fp32 and the
  smaller-than-the-kernel fallbacks). Both packages take the per-channel
  mean m in their own summation order (a few fp32 ulps apart), so
  d = x − m differs by that much, and a d that close to a bf16 rounding
  boundary rounds to the neighbouring bf16 value in one package: with 2 and
  3 passes d_lo carries the difference back (max |Δ| ≤ 1e-6 of max |ref|,
  fp32 summation order); with 1 pass each such flip, and the shift of m
  in the exact constant term, are counted and bound the difference
  element by element.
- Whole DepthNet forwards at ×2, ×3, ×4 and ×8 (nb 4, latent 16, K 4,
  LR 16×20 in each precision, and 16×16 in ``mixed``: the JAX module
  blends a style group in its kernel only at widths that are multiples of
  8, and the port then does too), on the JAX module's parameters
  (``from_flax``), on one torch thread. Where
  every bf16 rounding sits on operands both packages compute alike
  (``mixed``; ``bf16c3`` at ×2 / ×3, whose tail is not centered) the bar is
  the repo's 2e-4. Where one-pass centered convs run (``bf16c``, and
  ``bf16c3`` at ×4 / ×8, whose folded head JAX runs in one pass,
  ``endosr/nn/depthnet.py:1553``) the flips above spread through the
  trunk: the port must then lie closer to JAX than JAX's own precision lies
  to its fp32 forward (RMS ≤ 0.7 of it, i.e. ≥ 3 dB inside; measured
  ≥ 5.5 dB). ``mixed`` with ``valid_hw`` (bucketed serving) at 2e-4 on the
  crop.
- The port's own mismatch-PSNR against its fp32 forward on
  ``tests/test_bf16_quality.py``'s proxy (LR 48, 14 depth blocks, latent 32
  at ×2 and 64 at ×3, band-limited inputs, batch 1, the port's seeded
  weights) meets the JAX package's bounds: ``mixed`` ≥ 45 dB, ``bf16c`` ≥ 40
  / 38 dB, ``bf16c3`` ≥ 50 dB.
- Which kernel wrappers each precision's forward goes through, counted as
  ``tests/test_torch_hoisted.py`` counts them, equal to the calls of the
  JAX module's counterparts on the same configuration; and the port's
  copy of JAX's blend-kernel size model (``_jax_blend_fits``, which picks
  the route and so the rounding of a group of bf16 maps in an fp32 net)
  against ``style_blend_supported`` over a sweep of batch, frame, M and
  storage type, the ×2 and ×3 serving shapes included.
- ``FModelDepthCond`` reads ``precision`` as JAX does and serves the
  centered precisions unbucketed, warning once.
"""

import copy
import importlib
import itertools
import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import endosr.nn.depthnet as jax_dn
from endosr.nn import layers as jax_layers
from endosr.nn.depthnet import DepthNet as JaxDepthNet
from endosr.ops.masks import pool_mask_np
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.nn import depthnet as torch_dn
from endosr_torch.nn import layers as torch_layers
from endosr_torch.nn import sean as torch_sean
from endosr_torch.ops.masks import depth_masks_np
from endosr_torch.utils.port_params import from_flax, seeded_init

# the modules themselves: ``endosr.kernels`` exports functions of these names
jax_os = importlib.import_module("endosr.kernels.output_stage")
jax_pc = importlib.import_module("endosr.kernels.packed_chain")
jax_style_dot = importlib.import_module("endosr.kernels.style_dot")

TOL = 2e-4
PRECISIONS = {"mixed": 0, "bf16c": 1, "bf16c3": 3}   # → centered passes


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in this module: the suite runs several worker
    processes on the machine's cores, and the 14-block proxy's forwards
    slow down many times over when every worker's threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64_conv(x, w):
    """SAME conv of NHWC ``x`` by HWIO ``w`` in float64 (numpy in, out)."""
    y = torch.nn.functional.conv2d(
        torch.from_numpy(np.asarray(x, np.float64)).permute(0, 3, 1, 2),
        torch.from_numpy(np.asarray(w, np.float64)).permute(3, 2, 0, 1),
        padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1).numpy()


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


# ------------------------------------------------------------ centered_conv

def _cc_inputs(seed, shape=(2, 12, 10, 8), cout=6):
    """An offset-carrying stream (the regime centered convs exist for:
    σ 0.3 on a mean of 20) and a small kernel and bias."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.3 + 20.0).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("passes", [1, 2, 3])
def test_centered_conv_matches_jax(passes, bias):
    x, w, b = _cc_inputs(10 + passes)
    b = b if bias else None
    want = np.asarray(jax_layers.centered_conv(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        jnp.bfloat16, passes=passes))
    got = torch_layers.centered_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), torch.bfloat16, passes)
    assert got.dtype == torch.float32
    got = got.numpy()
    err = np.abs(got - want)
    scale = float(np.abs(want).max())
    if passes > 1:
        assert float(err.max()) <= 1e-6 * scale, float(err.max())
        return
    # one pass: the means' summation orders differ by a few ulps; count the
    # elements of d whose bf16 rounding that flips, and bound the output by
    # them and by the mean shift's path through the exact constant term
    m_j = np.asarray(jnp.mean(jnp.asarray(x), axis=(1, 2)))
    m_t = torch.from_numpy(x).mean(dim=(1, 2)).numpy()
    assert np.abs(m_j - m_t).max() <= 8 * np.spacing(np.abs(m_j).max())
    dd = np.abs(_bf16(x - m_j[:, None, None]) - _bf16(x - m_t[:, None, None]))
    flips = int((dd > 0).sum())               # 23 of 1920 at these seeds
    assert flips <= 0.05 * dd.size, flips
    w_abs = np.abs(_bf16(w))
    bound = (_f64_conv(dd, w_abs)
             + _f64_conv(np.broadcast_to(np.abs(m_j - m_t)[:, None, None],
                                         x.shape), np.abs(w))
             + 1e-6 * scale)
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("case", ["fp32", "smaller_than_kernel"])
def test_centered_conv_fallbacks_match_jax(case):
    """In fp32, or on an image smaller than the kernel, both packages run
    the plain fp32 conv."""
    x, w, b = _cc_inputs(20, (2, 2, 5, 8) if case == "smaller_than_kernel"
                         else (2, 12, 10, 8))
    dt = (jnp.float32, torch.float32) if case == "fp32" else (
        jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_layers.centered_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dt[0], passes=3))
    got = torch_layers.centered_conv(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), dt[1], 3).numpy()
    ref = _f64_conv(x, w) + b
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - want).max()) <= 1e-6 * scale
    assert float(np.abs(got - ref).max()) <= 1e-6 * scale


def test_centered_conv_passes_approach_the_exact_conv():
    """Against the float64 conv: one pass leaves the bf16 rounding of d and
    w (≈ 2⁻⁸ of the centred products), three passes ≈ 2⁻¹⁶ of them; both far
    below the plain bf16 conv, whose rounding is relative to the offset."""
    x, w, _ = _cc_inputs(30)
    ref = _f64_conv(x, w)
    t = (torch.from_numpy(x), torch.from_numpy(w))
    errs = [float(np.abs(torch_layers.centered_conv(*t, None, torch.bfloat16,
                                                     p).numpy() - ref).max())
            for p in (1, 2, 3)]
    plain = float(np.abs(_f64_conv(_bf16(x), _bf16(w)) - ref).max())
    d = x - x.mean(axis=(1, 2), keepdims=True)
    centred = float(_f64_conv(np.abs(d), np.abs(w)).max())
    assert errs[0] <= 2 ** -7 * centred < plain
    assert errs[2] <= 2 ** -14 * centred
    assert errs[2] < errs[1] < errs[0]


def test_centered_conv_field_needs_a_same_conv():
    torch_layers.Conv(4, 4, 3, centered=3)
    with pytest.raises(ValueError, match="centered"):
        torch_layers.Conv(4, 4, 3, stride=2, centered=1)
    with pytest.raises(ValueError, match="centered"):
        torch_layers.WNConv(4, 4, 3, padding=0, centered=1)


# --------------------------------------------------------- whole forwards

SMALL = dict(nb=4, depth_latent_ch=16, depth_range_num=4, style_chunk=2)
# nb = 4: trunk block 0, then blocks 2 (nb-2) and 3 (nb-1); at ×2 / ×3 every
# block is a depth block, as in the ×2 / ×3 YAMLs
WHICH = {2: (0, 2, 3), 3: (0, 2, 3), 4: (0,), 8: (0,)}


def _inputs(h, w, seed=3, b=2):
    rng = np.random.default_rng(seed)
    return (rng.random((b, h, w, 3), dtype=np.float32),
            rng.random((b, h, w, 1), dtype=np.float32),
            (rng.random((b, h, w, 4)) > 0.6).astype(np.float32))


def _t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax_net(scale, precision=None):
    kw = {}
    if precision is not None:
        kw = dict(modulation_dtype=jnp.bfloat16,
                  centered_convs=PRECISIONS[precision])
    return JaxDepthNet(**SMALL, scale=scale, which_resblk_depth=WHICH[scale],
                       **kw)


def _port_net(scale, precision, params):
    kw = {}
    if precision is not None:
        kw = dict(modulation_dtype=torch.bfloat16,
                  centered_convs=PRECISIONS[precision])
    net = torch_dn.DepthNet(**SMALL, scale=scale,
                            which_resblk_depth=WHICH[scale], device="cpu",
                            **kw)
    net.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params)),
                        strict=True)
    net.requires_grad_(False)
    return net


@pytest.fixture(scope="module")
def jax_fp32():
    """{(scale, (h, w)): (inputs, JAX params, JAX fp32 output)}, made once."""
    cache = {}

    def get(scale, hw):
        key = (scale, hw)
        if key not in cache:
            inputs = _inputs(*hw)
            net = _jax_net(scale)
            params = net.init(jax.random.PRNGKey(1), *inputs)["params"]
            cache[key] = (inputs, params,
                          np.asarray(net.apply({"params": params}, *inputs)))
        return cache[key]

    return get


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def _one_pass_convs(scale, precision):
    return precision == "bf16c" or (precision == "bf16c3" and scale >= 4)


# W 20: no style group fits JAX's blend kernel, every precision; W 16: the
# blend route, whose rounding is the same in the three (bf16 maps): mixed
FORWARD_CASES = ([(s, p, (16, 20)) for s in (2, 3, 4, 8) for p in PRECISIONS]
                 + [(s, "mixed", (16, 16)) for s in (2, 3, 4, 8)])


@pytest.mark.parametrize(
    "scale,precision,hw", FORWARD_CASES,
    ids=[f"{s}-{p}-w{hw[1]}" for s, p, hw in FORWARD_CASES])
def test_precision_forward_matches_jax(jax_fp32, scale, precision, hw):
    inputs, params, ref32 = jax_fp32(scale, hw)
    want = np.asarray(_jax_net(scale, precision).apply({"params": params},
                                                       *inputs))
    got = _port_net(scale, precision, params)(*_t(inputs)).numpy()
    assert got.shape == want.shape == (2, hw[0] * scale, hw[1] * scale, 3)
    assert np.isfinite(got).all()
    if _one_pass_convs(scale, precision):
        apart, own = _rms(got, want), _rms(want, ref32)
        assert apart <= 0.7 * own, (apart, own)
    else:
        err = float(np.abs(got - want).max())
        assert err <= TOL, f"max |Δ| {err:.3g} > {TOL}"


@pytest.mark.parametrize("scale", [2, 3, 4, 8])
def test_mixed_valid_hw_matches_jax(scale):
    """Bucketed serving of ``mixed``: an odd-sized input zero-padded to a
    multiple of 4, the masked forward (style groups through
    ``style_dot_hwbm``, blended in fp32), against JAX's on the crop."""
    h, w, hb, wb = 13, 18, 16, 20
    lq, dep, mk = _inputs(h, w, seed=5)
    pad = ((0, 0), (0, hb - h), (0, wb - w), (0, 0))
    padded = tuple(np.pad(a, pad) for a in (lq, dep, mk))
    pm = pool_mask_np(mk, (((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2),
                      (hb // 4, wb // 4))
    jnet = _jax_net(scale, "mixed")
    params = _jax_net(scale).init(jax.random.PRNGKey(2), *padded)["params"]
    want = np.asarray(jnet.apply({"params": params}, *padded,
                                 valid_hw=(np.int32(h), np.int32(w)),
                                 pool_mask=pm))
    got = _port_net(scale, "mixed", params)(
        *_t(padded), valid_hw=(h, w), pool_mask=torch.from_numpy(pm)).numpy()
    s = scale
    err = float(np.abs(got[:, :h * s, :w * s] - want[:, :h * s, :w * s]).max())
    assert err <= TOL, f"max |Δ| {err:.3g} > {TOL}"


# ------------------------------------------------- quality (the JAX proxy)

def _smooth(rng, shape, octaves=3):
    """Band-limited random image in [0, 1] (``tests/test_bf16_quality.py``)."""
    h, w = shape[:2]
    img = np.zeros(shape, np.float32)
    for o in range(octaves):
        s = 2 ** (o + 2)
        low = rng.random((max(2, h // s), max(2, w // s), shape[2])
                         ).astype(np.float32)
        img += cv2.resize(low, (w, h),
                          interpolation=cv2.INTER_CUBIC).reshape(shape)
    img -= img.min()
    return img / max(img.max(), 1e-6)


@pytest.fixture(scope="module")
def proxy():
    """{scale: (inputs, fp32 net, fp32 output)} at the JAX proxy's shape."""
    cache = {}

    def get(scale):
        if scale not in cache:
            rng = np.random.default_rng(9)
            lq = _smooth(rng, (48, 48, 3))[None]
            depth = _smooth(rng, (48, 48, 1))[None]
            masks = depth_masks_np(depth[0, ..., 0], True, 10)[None]
            inputs = _t((lq, depth, masks.astype(np.float32)))
            net = seeded_init(torch_dn.DepthNet(
                which_resblk_depth=tuple(range(14)), scale=scale,
                depth_latent_ch={2: 32, 3: 64}[scale], depth_range_num=10,
                device="cpu"), scale)
            net.requires_grad_(False)
            cache[scale] = (inputs, net, net(*inputs).numpy())
        return cache[scale]

    return get


@pytest.mark.parametrize("scale,precision,bound_db", [
    (2, "mixed", 45.0), (3, "mixed", 45.0),
    (2, "bf16c", 40.0), (3, "bf16c", 38.0),
    (2, "bf16c3", 50.0), (3, "bf16c3", 50.0),
])
def test_quality_meets_the_jax_bounds(proxy, scale, precision, bound_db):
    inputs, net32, out32 = proxy(scale)
    net = torch_dn.DepthNet(
        which_resblk_depth=tuple(range(14)), scale=scale,
        depth_latent_ch={2: 32, 3: 64}[scale], depth_range_num=10,
        modulation_dtype=torch.bfloat16,
        centered_convs=PRECISIONS[precision], device="cpu")
    net.load_state_dict(net32.state_dict())
    net.requires_grad_(False)
    psnr = _psnr(net(*inputs).numpy(), out32)
    print(f"×{scale} {precision}, batch 1: {psnr:.2f} dB")
    assert psnr >= bound_db, f"×{scale} {precision}: {psnr:.2f} dB"


@pytest.mark.slow           # four JAX forwards of the 14-block proxy, ≈ 60 s
@pytest.mark.parametrize("scale", [2, 3])
def test_blend_route_quality_matches_jax(scale):
    """At batch 2 both packages send the proxy's style groups through the
    blend kernel, which rounds the finished (γ, β) to bf16, and the SEAN's
    1 + γ then rounds in bf16: ``mixed`` and ``bf16c3`` read below the JAX
    package's certification (made at batch 1, where JAX blends in fp32) in
    both packages alike (JAX's weights; port within 0.5 dB of JAX; measured
    46.09 dB at ×2 and 44.41 dB at ×3 in both, for both precisions)."""
    rng = np.random.default_rng(9)
    lq = _smooth(rng, (48, 48, 3))[None]
    depth = _smooth(rng, (48, 48, 1))[None]
    masks = depth_masks_np(depth[0, ..., 0], True, 10)[None].astype(np.float32)
    inputs = tuple(np.repeat(a, 2, axis=0) for a in (lq, depth, masks))
    kw = dict(which_resblk_depth=tuple(range(14)), scale=scale,
              depth_latent_ch={2: 32, 3: 64}[scale], depth_range_num=10)
    j32 = JaxDepthNet(**kw)
    params = j32.init(jax.random.PRNGKey(scale), *inputs)["params"]
    ref_j = np.asarray(j32.apply({"params": params}, *inputs))
    sd = from_flax(jax.tree_util.tree_map(np.asarray, params))
    t32 = torch_dn.DepthNet(**kw, device="cpu")
    t32.load_state_dict(sd)
    t32.requires_grad_(False)
    ref_t = t32(*_t(inputs)).numpy()
    for precision in ("mixed", "bf16c3"):
        jn = JaxDepthNet(**kw, modulation_dtype=jnp.bfloat16,
                         centered_convs=PRECISIONS[precision])
        tn = torch_dn.DepthNet(**kw, modulation_dtype=torch.bfloat16,
                               centered_convs=PRECISIONS[precision],
                               device="cpu")
        tn.load_state_dict(sd)
        tn.requires_grad_(False)
        db_j = _psnr(np.asarray(jn.apply({"params": params}, *inputs)), ref_j)
        db_t = _psnr(tn(*_t(inputs)).numpy(), ref_t)
        print(f"×{scale} {precision}, batch 2: port {db_t:.2f} dB, "
              f"JAX {db_j:.2f} dB")
        assert abs(db_t - db_j) <= 0.5, (precision, db_t, db_j)


def _psnr(a, b):
    return 10 * np.log10(1.0 / float(np.mean((a.astype(np.float64) - b) ** 2)))


# ----------------------------------------------------------------- routing

_PORT_WRAPPERS = {
    torch_sean: ("style_blend_dot", "style_dot_hwbm", "fused_o_branch",
                 "fused_modulation", "fused_in_mod"),
    torch_dn: ("output_stage", "output_stage_x8", "packed_g123", "head_dot",
               "fused_tail"),
}
# the JAX module's counterpart of each wrapper: (module, function)
_JAX_COUNTERPARTS = {
    "style_blend_dot": (jax_dn, "style_blend_chunk"),
    "style_dot_hwbm": (jax_dn, "style_chunk_dot"),
    "output_stage": (jax_os, "output_stage"),
    "output_stage_x8": (jax_os, "output_stage_x8"),
    "packed_g123": (jax_pc, "packed_g123"),
}


def _count(monkeypatch, table):
    """Count the calls of every (module, name) of ``table`` {key: ...}."""
    calls = dict.fromkeys(table, 0)
    for key, (mod, name) in table.items():
        def counted(*a, _fn=getattr(mod, name), _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


ROUTE_CASES = {
    # (scale, precision, (h, w), masked) → the port's launches per forward
    "x2_mixed_w16": (2, "mixed", (16, 16), False,
                     {"style_blend_dot": 1, "output_stage": 1}),
    "x2_mixed_w20": (2, "mixed", (16, 20), False,
                     {"style_dot_hwbm": 1, "output_stage": 1}),
    "x2_mixed_valid_hw": (2, "mixed", (16, 20), True,
                          {"style_dot_hwbm": 1, "output_stage": 1}),
    "x2_bf16c3": (2, "bf16c3", (16, 16), False,
                  {"style_blend_dot": 1, "output_stage": 1}),
    "x3_bf16c3": (3, "bf16c3", (16, 20), False,
                  {"style_dot_hwbm": 1, "output_stage": 1}),
    "x3_bf16c": (3, "bf16c", (16, 16), False,
                 {"style_blend_dot": 1, "output_stage": 1}),
    "x4_bf16c3": (4, "bf16c3", (16, 16), False,
                  {"style_blend_dot": 1, "output_stage": 1}),
    "x8_bf16c": (8, "bf16c", (16, 16), False,
                 {"style_blend_dot": 1, "output_stage": 1}),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_precision_goes_through_the_jax_modules_kernels(case, monkeypatch):
    """The port's kernel wrappers per forward, and the JAX module's calls of
    their counterparts on the same configuration: the same numbers. Centered
    ×4 / ×8 tails take the dense folds and ``output_stage`` (no packed
    chain, no phase-split head), as in JAX."""
    scale, precision, hw, masked, want = ROUTE_CASES[case]
    inputs = _inputs(*hw, b=2)
    extra_t, extra_j = {}, {}
    if masked:
        h, w = hw[0] - 3, hw[1] - 2
        pm = pool_mask_np(inputs[2][:, :h, :w],
                          (((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2),
                          (hw[0] // 4, hw[1] // 4))
        extra_t = dict(valid_hw=(h, w), pool_mask=torch.from_numpy(pm))
        extra_j = dict(valid_hw=(np.int32(h), np.int32(w)), pool_mask=pm)
    params = _jax_net(scale).init(jax.random.PRNGKey(1), *inputs)["params"]
    net = _port_net(scale, precision, params)
    port = _count(monkeypatch, {n: (mod, n) for mod, names in
                                _PORT_WRAPPERS.items() for n in names})
    jcalls = _count(monkeypatch, _JAX_COUNTERPARTS)
    net(*_t(inputs), **extra_t)
    _jax_net(scale, precision).apply({"params": params}, *inputs, **extra_j)
    assert {k: v for k, v in port.items() if v} == want
    assert {k: v for k, v in jcalls.items() if v} == want


# which groups the JAX module blends: (H, W) of the mask stack, and (M,
# N conv) of a style group: the smoke and proxy groups, the ×2 (LQ 512²)
# and ×3 (LQ 191×166) ones, H or W off the 4-row / 8-column blocks, M that
# no channel slice divides or whose slice no conv width divides
_BLEND_HW = [(16, 16), (16, 20), (12, 24), (13, 24), (48, 48), (128, 128),
             (256, 256), (512, 512), (191, 166), (192, 168)]
_BLEND_M = [(32, 2), (96, 6), (1792, 14), (1536, 12), (768, 6), (264, 11),
            (384, 2)]


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b", [1, 2, 8, 9])
def test_blend_fits_is_the_jax_size_model(b, itemsize):
    """``_jax_blend_fits``, which decides where a style group of bf16 maps
    in an fp32 net goes (and so how it rounds), answers as JAX's
    ``style_blend_supported`` on every shape of the sweep."""
    for (h, w), (m, n) in itertools.product(_BLEND_HW, _BLEND_M):
        shape = (b, h, w, 90)
        assert (torch_dn._jax_blend_fits(shape, m, n, itemsize)
                == jax_style_dot.style_blend_supported(shape, m, n, itemsize)
                ), (shape, m, n, itemsize)


def test_blend_fits_answers_the_served_shapes():
    """The answers the ×2 / ×3 serving routes rest on: the batch-2 smoke
    group blends, the batch-8 ×2 request at LQ 512² and the ×3 frame at LQ
    191×166 do not, in both JAX's model and the port's copy."""
    for shape, m, n, fits in (((2, 16, 16, 90), 768, 6, True),
                              ((8, 512, 512, 90), 1792, 14, False),
                              ((8, 512, 512, 90), 1536, 12, False),
                              ((1, 191, 166, 90), 1792, 14, False)):
        assert torch_dn._jax_blend_fits(shape, m, n, 2) is fits
        assert jax_style_dot.style_blend_supported(shape, m, n, 2) is fits


# ------------------------------------------------------------------- model

OPT = {
    "is_train": False, "model": "sftmd_depthCond", "scale": 2,
    "datasets": {"test": {"depthMaskNum": 4}},
    "network_G": {"which_model_G": "DepthNet", "nb": 4, "depth_latent_ch": 16,
                  "which_ResBlk_depth": [0, 2, 3]},
    "path": {},
}


@pytest.mark.parametrize("precision,want", [
    ("mixed", (torch.float32, torch.bfloat16, 0)),
    ("bf16c", (torch.float32, torch.bfloat16, 1)),
    ("bf16c3", (torch.float32, torch.bfloat16, 3)),
    ("bf16", (torch.bfloat16, torch.bfloat16, 0)),
    ("fp32", (torch.float32, torch.float32, 0)),
])
def test_model_reads_precision_like_jax(precision, want):
    net = FModelDepthCond({**copy.deepcopy(OPT), "precision": precision},
                          device="cpu").netG
    assert (net.dtype, net.mod_dtype, net.centered_convs) == want
    block = net.block(0)
    assert block.conv1["0"].centered == want[2]


@pytest.mark.parametrize("precision", ["bf16c", "bf16c3", "mixed"])
def test_centered_precisions_serve_unbucketed(precision, caplog):
    """``bf16c`` / ``bf16c3`` turn the default bucketing off with one
    warning, as the JAX model does, and serve the unpadded forward;
    ``mixed`` stays bucketed."""
    m = FModelDepthCond({**copy.deepcopy(OPT), "precision": precision,
                         "network_G": {**OPT["network_G"],
                                       "preset": "serve_bf16c3"}},
                        device="cpu")
    rng = np.random.default_rng(6)
    batch = {"LQ": rng.random((1, 13, 18, 3), dtype=np.float32),
             "Depth": rng.random((1, 13, 18, 1), dtype=np.float32),
             "DepthMaskList": (rng.random((1, 13, 18, 4)) > 0.6
                               ).astype(np.float32)}
    with caplog.at_level(logging.WARNING, logger="base"):
        for _ in range(2):
            m.feed_data(batch)
            sr = m.test()
    warned = [r for r in caplog.records if "bucketing disabled" in r.message]
    assert sr.shape == (1, 26, 36, 3) and torch.isfinite(sr).all()
    if precision == "mixed":
        assert m._bucket() == 32 and not warned
        return
    assert m._bucket() == 0 and len(warned) == 1
    with torch.inference_mode():
        direct = m.netG(*_t([batch[k] for k in ("LQ", "Depth",
                                                 "DepthMaskList")]))
    assert torch.equal(sr, direct)
