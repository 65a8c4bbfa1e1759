"""The paper's ablations and the baseline net in the port against the JAX
package, on the CPU in fp32.

``ablate_depth_matrix`` (the ``EncoderNoDepthMatrix`` spatial latent and
two plain style convs a SEAN), ``ablate_depth_block`` (``mlp_depthMatrix``,
a plain transposed conv of the style matrix, and the ``mlp_*_all`` convs,
no blend) and the baseline (``which_ResBlk_depth: []``: the encoder's
first conv only, classic blocks everywhere), each at ×4 and ×2 on the
smoke network (nb 4, K 4, latent 16, batch 2, LR 15: the depth-matrix
ablation's encoder gives the feature's size back only for odd sizes, in
JAX as here), on the JAX training model's weights (``from_flax_train``):

- the forward with the clamp opened (so that every value is compared)
  within 2e-4 of the JAX DepthNet's;
- one training step of the ×4 / ×2 YAML's ``train:`` block: the logs to
  ≤ 1e-5 relative; every gradient by ``tests/test_torch_train_scales.py``'s
  ×3 rule, its norm-relative distance from JAX's within ``GRAD_NOISE`` ×
  the largest change of JAX's own under the one-ulp nudges +
  ``GRAD_FLOOR`` (on this batch the ×2 depth-block ablation sits at a
  ReLU's kink: the port's gradients are 1.1e-4 norm-relative from JAX's
  over all tensors, 6.2e-4 in the worst one); the conv biases before an
  InstanceNorm, whose true gradient is zero, within ``ZERO_GRAD`` of the
  largest gradient on both sides;
- exact bucketed eval (``valid_hw``) raises ``ValueError`` for the
  ablations, as in JAX, and ``FModelDepthCond`` serves them unpadded;
- ``from_flax`` carries every new parameter across and the JAX package's
  own porter carries it back unchanged, and the port's ``ConvTranspose``
  under that mapping equals JAX's ``ConvTranspose`` on a kernel that is
  not symmetric (the spatial flip JAX makes at call time is in the
  mapping).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from endosr.models.f_depthcond import FModelDepthCond as JaxModel
from endosr.nn.layers import ConvTranspose as JaxConvTranspose
from endosr.parallel.mesh import make_mesh
from endosr.utils.port_torch import port_state_dict
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.models.recipes import TRAIN_YAMLS, train_opt
from endosr_torch.nn.layers import ConvTranspose
from endosr_torch.utils.port_params import from_flax, from_flax_train
from tests.test_torch_train import (_before_instance_norm, _jax_loss_fn,
                                    _tree_np)
from tests.test_torch_train_scales import (GRAD_FLOOR, GRAD_NOISE, ZERO_GRAD,
                                           _nrel, jax_nudges)

K, LR, B = 4, 15, 2
TOL = 2e-4
NET = {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3, "nf": 64,
       "nb": 4, "depth_latent_ch": 16, "use_trainable_params": True}
# variant: network_G fields; at ×4 no depth block after upscale2 (the
# depth-matrix ablation's latent has the LR size)
VARIANTS = {"ablate_depth_matrix": {"ablate_depth_matrix": True},
            "ablate_depth_block": {"ablate_depth_block": True},
            "baseline": {"which_ResBlk_depth": []}}
DEPTH = {2: [0, 1, 2, 3], 4: [0, 1, 2]}
YAMLS = {2: TRAIN_YAMLS[("kvasir", 2)], 4: TRAIN_YAMLS[("kvasir", 4)]}


def _opt(variant, scale, **top):
    net = {**NET, "which_ResBlk_depth": DEPTH[scale], **VARIANTS[variant]}
    return {"is_train": True, "model": "sftmd_depthCond", "scale": scale,
            "precision": None,
            "datasets": {"train": {"depthMaskNum": K, "LR_size": LR}},
            "network_G": net, "path": {},
            "train": train_opt(YAMLS[scale])["train"], **top}


def _batch(scale, seed=21):
    rng = np.random.default_rng(seed)
    return {"GT": rng.random((B, LR * scale, LR * scale, 3), dtype=np.float32),
            "LQ": rng.random((B, LR, LR, 3), dtype=np.float32),
            "Depth": rng.random((B, LR, LR, 1), dtype=np.float32),
            "DepthMaskList": (rng.random((B, LR, LR, K)) > 0.6).astype(
                np.float32)}


def _port_model(opt, start):
    tm = FModelDepthCond(copy.deepcopy(opt), device="cpu")
    with torch.no_grad():
        for name, p in tm.named_train_parameters():
            p.copy_(start[name])
    return tm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in this module: the suite runs several worker
    processes on the machine's cores, and this module's steps slow down
    many times over when every worker's threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(variant, scale):
        if (variant, scale) not in cache:
            cache[variant, scale] = _run(variant, scale)
        return cache[variant, scale]

    return get


def _run(variant, scale):
    """The JAX model's forward (clamp opened) and first gradient, and the
    port's on its weights."""
    opt = _opt(variant, scale)
    jm = JaxModel(copy.deepcopy(opt), mesh=make_mesh(jax.devices()[:1]))
    params = jm.state.params
    batch = _batch(scale)
    x = [batch[k] for k in ("LQ", "Depth", "DepthMaskList")]
    wide = jm.netG.clone(clamp_min=-1e4, clamp_max=1e4)
    out = {"sr_jax": np.asarray(wide.apply({"params": params["netG"]}, *x)),
           "start": from_flax_train(_tree_np(params)),
           "tree_jax": _tree_np(params["netG"])}
    first_bin = np.random.default_rng(opt["train"]["manual_seed"]).integers(
        0, K)
    grad_fn = jax.jit(jax.grad(_jax_loss_fn(jm), has_aux=True))
    jb = dict(batch, mask_bin=np.int32(first_bin))
    grads, logs = grad_fn(params, jb)
    out["grads_jax"] = from_flax_train(_tree_np(grads))
    out["nudges"] = [from_flax_train(_tree_np(g))
                     for g in jax_nudges(grad_fn, params, jb)]
    out["logs_jax"] = {k: float(v) for k, v in jax.device_get(logs).items()
                       if k not in ("dyn_w", "dyn_l")}

    tm = _port_model(opt, out["start"])
    net = tm.netG
    net.clamp_min, net.clamp_max = -1e4, 1e4
    with torch.no_grad():
        out["sr"] = net(*map(torch.from_numpy, x)).numpy()
    net.clamp_min, net.clamp_max = 0.0, 1.0
    tm = _port_model(opt, out["start"])
    tm.feed_data(batch)
    out["logs"] = dict(tm.optimize_parameters())
    out["grads"] = {k: p.grad.clone() for k, p in tm.named_train_parameters()}
    return out


CASES = [(v, s) for v in VARIANTS for s in (4, 2)]
IDS = [f"{v}-x{s}" for v, s in CASES]


@pytest.mark.parametrize("variant,scale", CASES, ids=IDS)
def test_forward_matches_jax(runs, variant, scale):
    r = runs(variant, scale)
    assert r["sr"].shape == (B, LR * scale, LR * scale, 3)
    assert np.isfinite(r["sr"]).all()
    err = float(np.abs(r["sr"] - r["sr_jax"]).max())
    assert err <= TOL, f"max |Δ| {err:.3g}"


@pytest.mark.parametrize("variant,scale", CASES, ids=IDS)
def test_training_step_matches_jax(runs, variant, scale):
    r = runs(variant, scale)
    for k, v in r["logs_jax"].items():
        assert abs(r["logs"][k] - v) <= 1e-5 * max(abs(v), 1e-12), k
    got, want = r["grads"], r["grads_jax"]
    assert sorted(got) == sorted(want)
    top = max(float(g.abs().max()) for g in want.values())
    fails = []
    for k, w in want.items():
        if _before_instance_norm(k):
            worst = max(float(w.abs().max()), float(got[k].abs().max()))
            if not worst <= ZERO_GRAD * top:
                fails.append(f"{k}: |g| {worst:.3g}")
            continue
        err = _nrel(got[k], w)
        tol = GRAD_NOISE * max(_nrel(g[k], w) for g in r["nudges"])
        tol += GRAD_FLOOR
        if not err <= tol:
            fails.append(f"{k}: {err:.3g} > {tol:.3g}")
    assert not fails, fails


# names each variant must have (+) or lack (-) in the port's tree
NAMES = {
    "ablate_depth_matrix": (
        {"encoder.layer5.weight_v", "depth-residual1.norm1.mlp_beta_s.weight",
         "depth-residual1.norm1.alpha_gamma"},
        {"depth-residual1.norm1.A_i_j.weight"}),
    "ablate_depth_block": (
        {"depth-residual1.norm1.mlp_depthMatrix.weight",
         "depth-residual1.norm1.mlp_before_all.bias",
         "depth-residual1.norm1.mlp_gamma_all.weight",
         "depth-residual1.norm1.mlp_beta_all.weight"},
        {"depth-residual1.norm1.alpha_gamma",
         "depth-residual1.norm1.mlp_gamma_o.weight"}),
    "baseline": ({"encoder.layer1.weight_v", "classic-residual1.block.0.bias"},
                 {"encoder.layer2.weight_v", "depth-residual1.conv1.0.bias"}),
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_from_flax_round_trips_the_parameters(runs, variant):
    """``from_flax`` of the JAX tree loads into the port's module with
    every key (strict), and the JAX package's own porter maps the port's
    ``state_dict`` back onto the JAX tree bit for bit."""
    r = runs(variant, 4)
    sd = from_flax(r["tree_jax"])
    net = FModelDepthCond({**_opt(variant, 4), "is_train": False},
                          device="cpu").netG
    net.load_state_dict(sd, strict=True)
    back = port_state_dict({k: v.numpy() for k, v in net.state_dict().items()},
                           r["tree_jax"])
    want = jax.tree_util.tree_leaves_with_path(r["tree_jax"])
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    have, lack = NAMES[variant]
    assert have <= set(sd) and not lack & set(sd)


@pytest.mark.parametrize("variant", ["ablate_depth_matrix",
                                     "ablate_depth_block"])
def test_valid_hw_raises_for_the_ablations(variant):
    tm = FModelDepthCond({**_opt(variant, 4), "is_train": False},
                         device="cpu")
    b = _batch(4)
    x = [torch.from_numpy(b[k]) for k in ("LQ", "Depth", "DepthMaskList")]
    with pytest.raises(ValueError, match="ablations"):
        tm.netG(*x, valid_hw=(13, 14), pool_mask=x[2][:, :4, :4])
    assert tm._bucket() == 0                     # served unpadded
    tm.feed_data({k: b[k] for k in ("LQ", "Depth", "DepthMaskList")})
    assert tm.test().shape == (B, LR * 4, LR * 4, 3)


def test_conv_transpose_mapping_flips_the_kernel():
    """JAX keeps a transposed conv's kernel as (kh, kw, I, O) and flips it
    spatially when it is called; ``from_flax`` gives torch's (I, O, kh,
    kw) layout, under which the port's ``ConvTranspose`` is JAX's, on a
    kernel that is not symmetric (the flip changes it, and mapping the
    unflipped kernel gives another result)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 6, 4)).astype(np.float32)
    mod = JaxConvTranspose(features=5, kernel_size=3, strides=2, padding=1)
    params = jax.tree_util.tree_map(
        np.asarray, mod.init(jax.random.PRNGKey(1), x)["params"])
    kern = params["kernel"]
    assert not np.allclose(kern, kern[::-1, ::-1])
    want = np.asarray(mod.apply({"params": params}, x))
    sd = from_flax({"mlp_depthMatrix": params})
    conv = ConvTranspose(4, 5, 3, 2, 1, device="cpu")
    conv.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = conv(torch.from_numpy(x), torch.float32).numpy()
        assert got.shape == want.shape == (2, 13, 11, 5)
        assert float(np.abs(got - want).max()) <= 1e-5
        conv.weight.copy_(conv.weight.flip(2, 3))
        wrong = conv(torch.from_numpy(x), torch.float32).numpy()
    assert float(np.abs(wrong - want).max()) > 1e-2
