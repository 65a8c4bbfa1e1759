"""The port's hoisted trunk, ``net_kw`` fields and ``preset: plain`` against
the JAX package, on the CPU in fp32.

The hoisted SEAN branch functions take the same numpy weights as their JAX
counterparts (≤ 1e-5). Whole DepthNet forwards run on the JAX module's
parameters carried across by ``from_flax`` (strict, so every configuration
shares the one parameter tree) and must agree to 2e-4 max abs, the repo's
parity bar. On the CPU the JAX module reaches its Pallas kernels the way its
own tests do: ``fused_modulation`` in interpret mode, ``fused_tail`` through
its twin, ``fused_o_branch`` (bf16-only there) through ``hoisted_o_branch``.
Which kernel wrapper a configuration goes through is checked by counting
calls of the wrappers; the launch counts on the card are ``chip_smoke.py``'s.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import endosr.nn.sean as jax_sean
from endosr.nn.depthnet import DEPTHNET_PRESETS as JAX_PRESETS
from endosr.nn.depthnet import DepthNet as JaxDepthNet
from endosr.ops.masks import pool_mask_np
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.nn import depthnet as torch_dn
from endosr_torch.nn import sean as torch_sean
from endosr_torch.nn.networks import DEPTHNET_PRESETS
from endosr_torch.utils.port_params import from_flax

TOL = 2e-4


def _f32(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max())


# ---------------------------------------------------------------- branches

N, C, K, L = 3, 8, 4, 16


def _branch_weights(rng):
    """N instances' weights as (JAX o tuples, JAX s tuples, port o tuples,
    port s tuples, (α_γ, α_β) pairs)."""
    jo, js, to, ts, al = [], [], [], [], []
    for _ in range(N):
        wm, bm = _f32(rng, 3, 3, 1, 2 * C, s=0.3), _f32(rng, 2 * C, s=0.3)
        w2, b2 = _f32(rng, 3, 3, 2 * C, 2 * C, s=0.2), _f32(rng, 2 * C, s=0.3)
        aw, ab = _f32(rng, K, K, s=0.4), _f32(rng, K, s=0.2)
        wg, bg = _f32(rng, 3, 3, L, C, s=0.2), _f32(rng, C, s=0.2)
        wb, bb = _f32(rng, 3, 3, L, C, s=0.2), _f32(rng, C, s=0.2)
        jo.append(({"kernel": jnp.asarray(wm), "bias": jnp.asarray(bm)},
                   jnp.asarray(w2), jnp.asarray(b2)))
        js.append((jnp.asarray(aw)[None, None], jnp.asarray(ab),
                   {"kernel": jnp.asarray(wg), "bias": jnp.asarray(bg)},
                   {"kernel": jnp.asarray(wb), "bias": jnp.asarray(bb)}))
        to.append(tuple(map(_t, (wm, bm, w2, b2))))
        ts.append(tuple(map(_t, (aw, ab, wg, bg, wb, bb))))
        al.append(rng.random(2).astype(np.float32))
    return jo, js, to, ts, al


def _branch_inputs(rng, b=2, h=16, w=16):
    return (rng.random((b, h, w, 1), dtype=np.float32),
            (rng.random((b, h, w, K)) > 0.6).astype(np.float32),
            _f32(rng, b, K, L, s=0.5))


def _pairs_err(got, want):
    assert len(got) == len(want) == N
    return max(_err(g.numpy(), w_) for gp, wp in zip(got, want)
               for g, w_ in zip(gp, wp))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "vmask"])
def test_hoisted_o_branch_matches_jax(masked):
    rng = np.random.default_rng(31)
    jo, _, to, _, _ = _branch_weights(rng)
    d, _, _ = _branch_inputs(rng)
    vm = None
    if masked:
        vm = np.zeros((1, 16, 16, 1), np.float32)
        vm[:, :13, :11] = 1.0
    want = jax_sean.hoisted_o_branch(jo, jnp.asarray(d), jnp.float32,
                                     vmask=None if vm is None else jnp.asarray(vm))
    got = torch_sean.hoisted_o_branch(to, _t(d), torch.float32,
                                      vmask=None if vm is None else _t(vm))
    assert _pairs_err(got, want) <= 1e-5


def test_pallas_o_branch_matches_jax_hoisted_o_branch():
    """The operand stacking of the kernel route: same function as the
    two-conv hoist (the JAX kernel is bf16-only; its fp32 twin is checked in
    test_torch_kernels.py)."""
    rng = np.random.default_rng(32)
    jo, _, to, _, _ = _branch_weights(rng)
    d, _, _ = _branch_inputs(rng, h=9, w=14)
    want = jax_sean.hoisted_o_branch(jo, jnp.asarray(d), jnp.float32)
    got = torch_sean.pallas_o_branch(to, _t(d), torch.float32)
    assert _pairs_err(got, want) <= 1e-5


def test_hoisted_style_branch_matches_jax():
    rng = np.random.default_rng(33)
    _, js, _, ts, _ = _branch_weights(rng)
    _, mask, st = _branch_inputs(rng)
    want = jax_sean.hoisted_style_branch(js, jnp.asarray(mask),
                                         jnp.asarray(st), jnp.float32)
    got = torch_sean.hoisted_style_branch(ts, _t(mask), _t(st), torch.float32)
    assert _pairs_err(got, want) <= 1e-5


@pytest.mark.parametrize("hw", [(16, 16), (9, 14)],
                         ids=["pallas_interpret", "twin"])
def test_hoisted_blended_mods_matches_jax(hw):
    """16×16 reaches the JAX Pallas kernel (interpret mode on the CPU), 9×14
    its twin."""
    rng = np.random.default_rng(34)
    jo, js, to, ts, al = _branch_weights(rng)
    d, mask, st = _branch_inputs(rng, h=hw[0], w=hw[1])
    want = jax_sean.hoisted_blended_mods(
        jo, js, [(jnp.asarray(a[:1]), jnp.asarray(a[1:])) for a in al],
        jnp.asarray(d), jnp.asarray(mask), jnp.asarray(st), jnp.float32)
    got = torch_sean.hoisted_blended_mods(
        to, ts, [(_t(a[:1]), _t(a[1:])) for a in al], _t(d), _t(mask), _t(st),
        torch.float32)
    assert _pairs_err(got, want) <= 1e-5


# ---------------------------------------------------------- whole forwards

SMALL = dict(nb=6, depth_latent_ch=16, depth_range_num=4)
PLAIN = JAX_PRESETS["plain"]
X8 = dict(scale=8, which_resblk_depth=(0, 1, 2))
# name → (DepthNet fields for both packages, LR size)
CONFIGS = {
    "pallas_obranch": (dict(X8, pallas_obranch=True), (16, 16)),
    "pallas_obranch_chunk2": (dict(X8, pallas_obranch=True, hoist_chunk=2),
                              (16, 20)),
    "fused_modulation": (dict(X8, fused_modulation=True), (16, 16)),
    "fused_modulation_chunk2": (dict(X8, fused_modulation=True, hoist_chunk=2),
                                (16, 16)),
    "pallas_tail": (dict(X8, pallas_tail=True), (16, 16)),
    "pallas_tail_non_square": (dict(X8, pallas_tail=True), (16, 20)),
    "fused_modulation+pallas_tail": (dict(X8, fused_modulation=True,
                                          pallas_tail=True), (16, 16)),
    "hoisted_chunk0": (dict(X8, lazy_branches=False), (16, 20)),
    "hoisted_chunk2": (dict(X8, lazy_branches=False, hoist_chunk=2), (16, 20)),
    "hoisted_no_style": (dict(X8, lazy_branches=False, hoist_style=False),
                         (16, 16)),
    "lazy_no_style": (dict(X8, hoist_style=False), (16, 16)),
    "plain_x2": (dict(PLAIN, scale=2, which_resblk_depth=(0, 1, 2, 4, 5)),
                 (16, 20)),
    "plain_x3": (dict(PLAIN, scale=3, which_resblk_depth=(0, 1)), (16, 20)),
    "plain_x4_depth_at_nb1": (dict(PLAIN, scale=4,
                                   which_resblk_depth=(0, 1, 5)), (16, 20)),
    "plain_x8": (dict(PLAIN, **X8), (16, 20)),
    "x4_depth_at_nb1": (dict(scale=4, which_resblk_depth=(0, 1, 5)), (16, 20)),
    "x8_depth_at_nb1": (dict(scale=8, which_resblk_depth=(0, 5)), (16, 16)),
    "packed_up1_off": (dict(X8, packed_up1=False), (16, 20)),
    "packed_tail_off": (dict(X8, packed_tail=False), (16, 20)),
    "pallas_head_off": (dict(X8, pallas_head=False), (16, 20)),
    "pallas_head_and_output_off": (dict(X8, pallas_head=False,
                                        pallas_output=False), (16, 20)),
    "pallas_style_blend_off": (dict(X8, pallas_style_blend=False), (16, 16)),
    "pallas_style_both_off": (dict(X8, pallas_style_blend=False,
                                   pallas_style=False), (16, 16)),
    "x4_fold_tail_off": (dict(scale=4, which_resblk_depth=(0, 1),
                              fold_tail=False), (16, 20)),
    "x4_fold_output_conv_off": (dict(scale=4, which_resblk_depth=(0, 1),
                                     fold_output_conv=False), (16, 20)),
    "x8_fold_tail_off": (dict(X8, fold_tail=False), (16, 16)),
    "x2_pallas_output_off": (dict(scale=2, which_resblk_depth=(0, 1, 4),
                                  pallas_output=False), (16, 20)),
    "x4_pallas_output_off": (dict(scale=4, which_resblk_depth=(0, 1),
                                  pallas_output=False), (16, 20)),
}


def _inputs(h, w, seed=3, b=2):
    rng = np.random.default_rng(seed)
    return (rng.random((b, h, w, 3), dtype=np.float32),
            rng.random((b, h, w, 1), dtype=np.float32),
            (rng.random((b, h, w, 4)) > 0.6).astype(np.float32))


def _pair(kw, inputs):
    jnet = JaxDepthNet(**SMALL, **kw)
    params = jnet.init(jax.random.PRNGKey(1), *inputs)["params"]
    net = torch_dn.DepthNet(**SMALL, **kw, device="cpu")
    net.load_state_dict(
        from_flax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    net.requires_grad_(False)         # forwards only: no autograd graph
    return jnet, params, net


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configuration_matches_jax(name):
    kw, (h, w) = CONFIGS[name]
    inputs = _inputs(h, w)
    jnet, params, net = _pair(kw, inputs)
    want = np.asarray(jnet.apply({"params": params}, *inputs))
    got = net(*map(_t, inputs)).numpy()
    s = kw["scale"]
    assert got.shape == (2, h * s, w * s, 3) and np.isfinite(got).all()
    err = _err(got, want)
    assert err <= TOL, f"{name}: max |Δ| {err:.3g} > {TOL}"


def test_no_forward_reaches_mid_shuffle():
    """As in the JAX package, ``mid_shuffle`` is a kernel that no DepthNet
    forward calls: the module has no such field and does not import it."""
    with pytest.raises(TypeError, match="mid_shuffle"):
        torch_dn.DepthNet(**SMALL, **X8, mid_shuffle=True, device="cpu")
    assert not hasattr(torch_dn, "mid_shuffle")


@pytest.mark.parametrize("field", ["pallas_obranch", "fused_modulation",
                                   "pallas_tail"])
def test_valid_hw_routes_by_configuration_and_matches_jax(field, monkeypatch):
    """Under exact bucketed eval the three kernel fields take the masked
    routes (``hoisted_o_branch(vmask=...)``; no packed tail, so no
    ``fused_tail``), as the JAX module does, and match it on the crop."""
    h, w, hb, wb = 13, 18, 16, 20
    lq, dep, mk = _inputs(h, w, seed=5)
    pad = ((0, 0), (0, hb - h), (0, wb - w), (0, 0))
    padded = tuple(np.pad(a, pad) for a in (lq, dep, mk))
    pm = pool_mask_np(mk, (((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2),
                      (hb // 4, wb // 4))
    kw = dict(X8, **{field: True})
    jnet, params, net = _pair(kw, padded)
    want = np.asarray(jnet.apply({"params": params}, *padded,
                                 valid_hw=(np.int32(h), np.int32(w)),
                                 pool_mask=pm))
    calls = _count_calls(monkeypatch)
    got = net(*map(_t, padded), valid_hw=(h, w), pool_mask=_t(pm)).numpy()
    assert _err(got[:, :h * 8, :w * 8], want[:, :h * 8, :w * 8]) <= TOL
    assert calls["fused_o_branch"] == calls["fused_modulation"] == 0
    assert calls["fused_tail"] == calls["packed_g123"] == 0
    # only pallas_obranch leaves the lazy path when masked
    assert calls["hoisted_o_branch"] == (field == "pallas_obranch")


# ----------------------------------------------------------------- routing

_WRAPPERS = {
    torch_sean: ("fused_o_branch", "fused_modulation", "style_blend_dot",
                 "style_dot_hwbm"),
    torch_dn: ("fused_tail", "head_dot", "output_stage_x8", "output_stage",
               "packed_g123", "hoisted_o_branch",
               "hoisted_style_branch"),
}


def _count_calls(monkeypatch):
    """Count the calls of every kernel wrapper (and the two plain hoists)
    the DepthNet forward can reach."""
    calls = {}
    for mod, names in _WRAPPERS.items():
        for name in names:
            calls[name] = 0

            def counted(*a, _fn=getattr(mod, name), _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, counted)
    return calls


TAIL = {"packed_g123": 2, "head_dot": 1, "output_stage_x8": 1}
ROUTES = {
    "default": ({}, {"style_blend_dot": 2, **TAIL}),
    "pallas_obranch": (dict(pallas_obranch=True),
                       {"fused_o_branch": 1, "hoisted_style_branch": 1, **TAIL}),
    "pallas_obranch_chunk2": (dict(pallas_obranch=True, hoist_chunk=2),
                              {"fused_o_branch": 2, "hoisted_style_branch": 2,
                               **TAIL}),
    "fused_modulation": (dict(fused_modulation=True),
                         {"fused_modulation": 1, **TAIL}),
    "pallas_tail": (dict(pallas_tail=True),
                    {"style_blend_dot": 2, "packed_g123": 2, "fused_tail": 1}),
    "hoisted": (dict(lazy_branches=False),
                {"hoisted_o_branch": 1, "hoisted_style_branch": 1, **TAIL}),
    "plain": (PLAIN, {"hoisted_o_branch": 1, "hoisted_style_branch": 1}),
    "dense_tail": (dict(packed_tail=False),
                   {"style_blend_dot": 2, "output_stage_x8": 1}),
    "pallas_head_off": (dict(pallas_head=False),
                        {"style_blend_dot": 2, "packed_g123": 2,
                         "output_stage_x8": 1}),
    "pallas_style_blend_off": (dict(pallas_style_blend=False),
                               {"style_dot_hwbm": 2, **TAIL}),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_configuration_goes_through_its_kernels(name, monkeypatch):
    """nb = 6 with three trunk depth blocks and ``style_chunk=2``: two lazy
    style groups, one hoist group unless chunked."""
    kw, want = ROUTES[name]
    net = torch_dn.DepthNet(**SMALL, **X8, **{"style_chunk": 2, **kw},
                            device="cpu")
    net.init_(torch.Generator().manual_seed(0))
    calls = _count_calls(monkeypatch)
    net(*map(_t, _inputs(16, 16, b=1)))
    assert {k: v for k, v in calls.items() if v} == want


# ------------------------------------------------------------ the options

OPT = {
    "is_train": False, "model": "sftmd_depthCond", "scale": 8,
    "precision": None, "eval_bucket_multiple": 0,
    "datasets": {"test": {"depthMaskNum": 4}},
    "network_G": {"which_model_G": "DepthNet", "nb": 6, "depth_latent_ch": 16,
                  "which_ResBlk_depth": [0, 1, 2]},
    "path": {},
}


def _opt(**net):
    opt = copy.deepcopy(OPT)
    opt["network_G"].update(net)
    return opt


def test_model_reads_net_kw_over_the_preset():
    m = FModelDepthCond(_opt(preset="serve",
                             net_kw={"pallas_obranch": True, "style_chunk": 3}),
                        device="cpu")
    assert m.netG.pallas_obranch and m.netG.style_chunk == 3
    assert FModelDepthCond(_opt(preset="serve"), device="cpu").netG.style_chunk == 5
    m = FModelDepthCond(_opt(preset="plain", net_kw={"hoist_chunk": 2}),
                        device="cpu")
    n = m.netG
    assert not (n.lazy_branches or n.packed_tail or n.packed_up1 or n.fold_tail
                or n.fold_output_conv or n.pallas_output or n.pallas_head
                or n.pallas_style or n.pallas_tail)
    assert n.hoist_chunk == 2 and n.style_chunk == 1 and n.pallas_style_blend


def test_presets_are_the_jax_presets():
    assert DEPTHNET_PRESETS == JAX_PRESETS


@pytest.mark.parametrize("preset", list(JAX_PRESETS))
def test_model_serves_every_preset_like_jax_default_fields(preset):
    """A served request of each preset equals the default configuration's on
    the same weights (the presets change the graph, not the function)."""
    rng = np.random.default_rng(41)
    batch = {"LQ": rng.random((1, 16, 16, 3), dtype=np.float32),
             "Depth": rng.random((1, 16, 16, 1), dtype=np.float32),
             "DepthMaskList": (rng.random((1, 16, 16, 4)) > 0.6).astype(np.float32)}
    ref = FModelDepthCond(_opt(), device="cpu")
    m = FModelDepthCond(_opt(preset=preset), device="cpu")
    m.netG.load_state_dict(ref.netG.state_dict(), strict=True)
    ref.feed_data(batch)
    m.feed_data(batch)
    assert float((m.test() - ref.test()).abs().max()) <= TOL


@pytest.mark.parametrize("net_kw,exc,match", [
    ({"no_such_field": 1}, TypeError, "no_such_field"),
], ids=lambda v: next(iter(v)) if isinstance(v, dict) else None)
def test_unported_or_unknown_net_kw_field_raises_by_name(net_kw, exc, match):
    """An unknown field raises ``TypeError`` by name (the JAX module's
    lowering switches: :func:`test_lowering_switch_net_kw_serves_default_
    output`)."""
    with pytest.raises(exc, match=match):
        FModelDepthCond(_opt(net_kw=net_kw), device="cpu")


@pytest.mark.parametrize("net_kw", [
    {"blend_fold": True}, {"lazy_o_chunk": 2}, {"mask_stack_conv": False},
    {"chain_in": False}, {"obranch_body": "dot"},
    {"pallas_packed_chain": False},
], ids=lambda v: next(iter(v)))
def test_lowering_switch_net_kw_serves_default_output(net_kw):
    """Each of the JAX module's lowering switches builds and serves the
    default fields' output on the same weights (≤ 2e-4; their parity with
    JAX: ``tests/test_torch_jax_only_arms.py``)."""
    rng = np.random.default_rng(43)
    batch = {"LQ": rng.random((1, 16, 16, 3), dtype=np.float32),
             "Depth": rng.random((1, 16, 16, 1), dtype=np.float32),
             "DepthMaskList": (rng.random((1, 16, 16, 4)) > 0.6).astype(
                 np.float32)}
    ref = FModelDepthCond(_opt(), device="cpu")
    m = FModelDepthCond(_opt(net_kw=net_kw), device="cpu")
    m.netG.load_state_dict(ref.netG.state_dict(), strict=True)
    ref.feed_data(batch)
    m.feed_data(batch)
    assert float((m.test() - ref.test()).abs().max()) <= TOL


def test_unported_field_at_its_jax_default_is_accepted():
    m = FModelDepthCond(_opt(net_kw={"blend_fold": False, "chain_in": True,
                                     "tail_defer_act": True}), device="cpu")
    assert m.netG.lazy_branches


def test_unknown_preset_raises_like_jax():
    with pytest.raises(ValueError, match="preset"):
        FModelDepthCond(_opt(preset="fastest"), device="cpu")
