"""The port's ×8 DepthNet forward against the JAX DepthNet, on the CPU in fp32.

The JAX module is initialised with ``PRNGKey(0)`` and its parameters are
carried across with ``endosr_torch.utils.port_params.from_flax``; both
forwards take the same numpy inputs. The whole forward must agree to
2e-4 max abs (the repo's parity bar, tests/test_depthnet_parity.py), and
so must each stage: the encoder's outputs (trunk feature and style matrix),
every trunk block's output, and g3 of both packed chains.

At LR 16 the JAX module's support gates route its head through the dense
head conv instead of head_dot + output_stage_x8 (the fine grid's 32
columns are not a multiple of 128); that is the same function, so the
port's head_dot path is held to the same bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import endosr.kernels.packed_chain as jax_pc
from endosr.nn.depthnet import DepthNet as JaxDepthNet
from endosr.nn.depthnet import DepthResidualBlock as JaxDRB
from endosr.nn.depthnet import Encoder as JaxEncoder
from endosr_torch.nn import depthnet as torch_dn
from endosr_torch.utils.port_params import from_flax

KW = dict(scale=8, nb=6, which_resblk_depth=(0, 1, 2), depth_latent_ch=16,
          depth_range_num=4, style_chunk=2)
B, LR = 2, 16
TOL = 2e-4


def _inputs():
    rng = np.random.default_rng(0)
    lq = rng.random((B, LR, LR, 3), dtype=np.float32)
    dep = rng.random((B, LR, LR, 1), dtype=np.float32)
    mk = (rng.random((B, LR, LR, 4)) > 0.6).astype(np.float32)
    return lq, dep, mk


@pytest.fixture(scope="module")
def runs():
    lq, dep, mk = _inputs()
    jnet = JaxDepthNet(**KW)
    params = jnet.init(jax.random.PRNGKey(0), lq, dep, mk)["params"]

    rec_j = {"blocks": [], "g3": []}

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            if isinstance(context.module, JaxEncoder):
                rec_j["enc"] = out
            elif isinstance(context.module, JaxDRB):
                rec_j["blocks"].append(out)
        return out

    orig = jax_pc.packed_g123

    def jax_g123(*a, **k):
        out = orig(*a, **k)
        rec_j["g3"].append(out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_pc, "packed_g123", jax_g123)
    try:
        with fnn.intercept_methods(intercept):
            want = np.asarray(jnet.apply({"params": params}, lq, dep, mk))
    finally:
        mp.undo()

    net = torch_dn.DepthNet(**KW, device="cpu")
    params_np = jax.tree_util.tree_map(np.asarray, params)
    net.load_state_dict(from_flax(params_np), strict=True)
    net.requires_grad_(False)         # a forward only: no autograd graph
    rec_t = {"blocks": [], "g3": []}
    net.encoder.register_forward_hook(
        lambda m, a, o: rec_t.__setitem__("enc", o))
    for i in KW["which_resblk_depth"]:
        net.block(i).register_forward_hook(
            lambda m, a, o: rec_t["blocks"].append(o))
    orig_t = torch_dn.packed_g123

    def torch_g123(*a, **k):
        out = orig_t(*a, **k)
        rec_t["g3"].append(out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(torch_dn, "packed_g123", torch_g123)
    try:
        got = net(torch.from_numpy(lq), torch.from_numpy(dep),
                  torch.from_numpy(mk)).numpy()
    finally:
        mp.undo()
    return want, got, rec_j, rec_t


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= TOL, f"{what}: max |Δ| {err:.3g} > {TOL}"


def test_forward_matches_jax(runs):
    want, got, _, _ = runs
    assert got.shape == (B, 8 * LR, 8 * LR, 3)
    assert np.isfinite(got).all()
    _close(want, got, "SR output")


@pytest.mark.parametrize("stage", ["encoder_feature", "style_matrix"])
def test_encoder_stages_match_jax(runs, stage):
    _, _, rec_j, rec_t = runs
    k = 0 if stage == "encoder_feature" else 1
    _close(rec_j["enc"][k], rec_t["enc"][k].numpy(), stage)


@pytest.mark.parametrize("block", [0, 1, 2])
def test_trunk_blocks_match_jax(runs, block):
    _, _, rec_j, rec_t = runs
    assert len(rec_j["blocks"]) == len(rec_t["blocks"]) == 3
    _close(rec_j["blocks"][block], rec_t["blocks"][block].numpy(),
           f"trunk block {block}")


@pytest.mark.parametrize("chain", ["up1", "tail"])
def test_packed_chain_g3_matches_jax(runs, chain):
    _, _, rec_j, rec_t = runs
    k = 0 if chain == "up1" else 1
    assert len(rec_j["g3"]) == len(rec_t["g3"]) == 2
    _close(rec_j["g3"][k], rec_t["g3"][k].numpy(), f"{chain} g3")


# ---------------------------------------------------------------------------
# Every scale, the masked (exact bucketed) forward and the fused epilogue:
# whole forwards on carried-across weights.
# ---------------------------------------------------------------------------

from endosr.ops.masks import pool_mask_np as jax_pool_mask_np  # noqa: E402
from endosr_torch.ops.masks import pool_mask_np  # noqa: E402

SMALL = dict(nb=5, depth_latent_ch=16, depth_range_num=4, style_chunk=2)
# nb = 5: trunk blocks 0 and 1, then blocks 3 (nb-2) and 4 (nb-1); index 2 is
# never built, as in the JAX module
SCALE_CASES = {
    "x2_all_depth": dict(scale=2, which_resblk_depth=(0, 1, 2, 3, 4)),
    "x3": dict(scale=3, which_resblk_depth=(0, 1)),
    "x3_all_depth": dict(scale=3, which_resblk_depth=(0, 1, 2, 3, 4)),
    "x4": dict(scale=4, which_resblk_depth=(0, 1)),
    "x4_depth_at_nb2": dict(scale=4, which_resblk_depth=(0, 1, 3)),
    "x4_classic_in_trunk": dict(scale=4, which_resblk_depth=(1,)),
    "x8_depth_at_nb2": dict(scale=8, which_resblk_depth=(0, 1, 3)),
    "x4_fused_epilogue": dict(scale=4, which_resblk_depth=(0, 1),
                              fused_epilogue=True),
    "x2_fused_epilogue": dict(scale=2, which_resblk_depth=(0, 1, 2, 3, 4),
                              fused_epilogue=True),
}


def _rand_inputs(h, w, seed=3, b=2, k=4):
    rng = np.random.default_rng(seed)
    return (rng.random((b, h, w, 3), dtype=np.float32),
            rng.random((b, h, w, 1), dtype=np.float32),
            (rng.random((b, h, w, k)) > 0.6).astype(np.float32))


def _pair(kw, lq, dep, mk):
    """(JAX module, its params, the port's module with the same weights)."""
    jnet = JaxDepthNet(**SMALL, **kw)
    params = jnet.init(jax.random.PRNGKey(1), lq, dep, mk)["params"]
    tkw = dict(kw)
    if tkw.get("fused_epilogue"):
        tkw["in_stats"] = "kernel"     # on the CPU: the kernel's plain version
    net = torch_dn.DepthNet(**SMALL, **tkw, device="cpu")
    net.load_state_dict(
        from_flax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    net.requires_grad_(False)         # forwards only: no autograd graph
    return jnet, params, net


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("case", list(SCALE_CASES))
def test_scales_match_jax(case):
    kw = SCALE_CASES[case]
    lq, dep, mk = _rand_inputs(16, 20)
    jnet, params, net = _pair(kw, lq, dep, mk)
    want = np.asarray(jnet.apply({"params": params}, lq, dep, mk))
    got = net(*_t(lq, dep, mk)).numpy()
    s = kw["scale"]
    assert got.shape == (2, 16 * s, 20 * s, 3)
    _close(want, got, case)


MASKED_CASES = {
    "x8": dict(scale=8, which_resblk_depth=(0, 1)),
    "x4": dict(scale=4, which_resblk_depth=(0, 1)),
    "x3_all_depth": dict(scale=3, which_resblk_depth=(0, 1, 2, 3, 4)),
    "x2_all_depth": dict(scale=2, which_resblk_depth=(0, 1, 2, 3, 4)),
    "x8_depth_at_nb2": dict(scale=8, which_resblk_depth=(0, 1, 3)),
}


@pytest.mark.parametrize("case", list(MASKED_CASES))
def test_valid_hw_matches_jax_and_unpadded(case):
    """An odd-sized input zero-padded to a multiple of 4: the masked forward
    equals the JAX masked forward on the crop (2e-4) and the port's own
    forward of the unpadded input (1e-4, fp32 summation order only)."""
    kw = MASKED_CASES[case]
    h, w, hb, wb = 13, 18, 16, 20
    s = kw["scale"]
    lq, dep, mk = _rand_inputs(h, w, seed=5)
    pad = ((0, 0), (0, hb - h), (0, wb - w), (0, 0))
    lqp, depp, mkp = (np.pad(a, pad) for a in (lq, dep, mk))
    v3 = (((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2)
    pm = pool_mask_np(mk, v3, (hb // 4, wb // 4))
    np.testing.assert_array_equal(
        pm, jax_pool_mask_np(mk, v3, (hb // 4, wb // 4)))

    jnet, params, net = _pair(kw, lqp, depp, mkp)
    want = np.asarray(jnet.apply(
        {"params": params}, lqp, depp, mkp,
        valid_hw=(np.int32(h), np.int32(w)), pool_mask=pm))
    got = net(*_t(lqp, depp, mkp), valid_hw=(h, w),
              pool_mask=torch.from_numpy(pm)).numpy()
    assert got.shape == (2, hb * s, wb * s, 3)
    _close(want[:, :h * s, :w * s], got[:, :h * s, :w * s], f"{case} crop")

    plain = net(*_t(lq, dep, mk)).numpy()
    err = float(np.abs(plain - got[:, :h * s, :w * s]).max())
    assert err <= 1e-4, f"{case}: masked vs unpadded max |Δ| {err:.3g}"


def test_valid_hw_with_fused_epilogue_raises():
    net = torch_dn.DepthNet(**SMALL, scale=4, which_resblk_depth=(0, 1),
                            fused_epilogue=True, device="cpu")
    lq, dep, mk = _t(*_rand_inputs(16, 16))
    with pytest.raises(ValueError, match="fused epilogue"):
        net(lq, dep, mk, valid_hw=(13, 14), pool_mask=mk[:, :4, :4])


@pytest.mark.parametrize("kw", [
    dict(scale=4, which_resblk_depth=(0, 1, 4), tail_defer_act=False),
    dict(scale=8, which_resblk_depth=(0, 4), blend_fold=True),
    dict(scale=4, which_resblk_depth=(0,), lazy_o_chunk=2),
    dict(scale=16, which_resblk_depth=(0,)),
], ids=["x4_depth_at_nb1", "x8_depth_at_nb1", "lazy_o_chunk", "x16"])
def test_unported_depthnet_configurations_raise(kw):
    with pytest.raises(NotImplementedError):
        torch_dn.DepthNet(**SMALL, **kw, device="cpu")
