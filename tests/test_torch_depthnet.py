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
