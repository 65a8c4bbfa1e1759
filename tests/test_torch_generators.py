"""Every generator ``define_G`` builds besides DepthNet, and the FCNs of
``define_SegNet``, against the JAX package's modules on the same weights
(fp32, the CPU), and the checkpoint loader's strict rule (C10).

- Forwards: the JAX module's parameters (seeded numpy leaves on its
  ``eval_shape`` tree) carried by ``from_flax`` load strictly into the
  port's module, whose ``state_dict`` keys are exactly JAX's
  ``flax_path_to_torch_key`` of its leaves; every output within 2e-4 of
  the largest JAX output (measured ≤ 6.8e-6), at every scale the
  generator takes. The depth variant with ``use_attention`` is
  ill-conditioned at its init: a one-ulp move of the LR image moves JAX's
  own output by 6.6e-4 of its largest value, so it is held by the one-ulp
  nudge rule (4× the larger of the two packages' own moves; port against
  JAX measured 6.7e-4). Sizes: MSRResNet nf 16 nb 2; RRDBNet nf 16 nb 1 (gc
  32 through ``define_G``, which passes no gc, as in JAX; gc 8 as a
  module); the SFT networks nb 2–5 (their nf is 64 in both packages, see
  ``nn/sftmd.py``); batch 2, LR 10×12. The FCNs at 32² in training mode
  (batch statistics; the running statistics after the call held to
  flax's ``batch_stats``) and in eval mode.
- The quadratic ``PositionAttention`` (built by no network) alone.
- Checkpoints: a seeded ``.pth`` of each generator loads with
  ``strict_load: true`` through ``create_model`` and gives the same
  weights, and the JAX porter reads it to the same weights. C10: a
  DepthNet dict with a reference checkpoint's dead ``depth-residual14.*``
  tensors loads strictly (they are dropped and logged) and equals the
  seeded net; a missing key still raises, naming it; a shape that does
  not match raises.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from endosr.nn import networks as jax_networks
from endosr.nn import sftmd_variants as jax_variants
from endosr.utils.checkpoint import load_network as jax_load_network
from endosr.utils.port_torch import flatten_params, flax_path_to_torch_key
from endosr_torch.models import create_model
from endosr_torch.models.base import BaseModel
from endosr_torch.nn import fcn as t_fcn
from endosr_torch.nn import networks, rrdb, sftmd_variants
from endosr_torch.utils.port_params import (from_flax, from_flax_stats,
                                            from_flax_variables, seeded_init)
from tests.torch_models_common import seeded_leaves
from tests.torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(1)
X = RNG.random((2, 10, 12, 3), np.float32)
DEPTH = RNG.random((2, 10, 12, 1), np.float32)
CODE = RNG.random((2, 10), np.float32)


def jax_variables(module, *inputs, seed=0, **kw):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *inputs, **kw))
    return seeded_leaves(dict(shapes), seed)


def _close(got, want, tol=2e-4):
    w = np.asarray(want)
    g = got.detach().numpy()
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * max(float(np.abs(w).max()), 1e-12), err


# (network_G, scales, inputs)
GENERATORS = {
    "MSRResNet": ({"nf": 16, "nb": 2}, (2, 3, 4), (X,)),
    "SRResNet": ({"nf": 16, "nb": 1}, (4,), (X,)),
    "RRDBNet": ({"nf": 16, "nb": 1}, (4,), (X,)),
    "SFTMD": ({"nb": 2}, (2, 3, 4, 8), (X,)),
    "SFTMD_kernel": ({"nb": 2}, (2, 3, 4), (X, CODE)),
    "SFTMD_DEMO": ({"nb": 2}, (2, 3, 4), (X, CODE)),
    "SFTMD_upsacle_after_ResBlk": ({"nb": 4}, (8,), (X,)),
    "SFTMD_upsacle_after_ResBlk_depth_condition": (
        {"nb": 5, "which_ResBlk_depth": [0, 3, 4]}, (8,), (X, DEPTH)),
    "SFTMD_upsacle_after_ResBlk_depth": (
        {"nb": 5, "n_depthResBlk": 3, "predict_depth_map": True,
         "use_attention": True}, (8,), (X, DEPTH)),
    "Predictor": ({}, (4,), (X,)),
    "Corrector": ({}, (4,), (X, CODE)),
}
CASES = [(name, s) for name, (_, scales, _) in GENERATORS.items()
         for s in scales]


def _pair(name, scale, **over):
    net, _, inputs = GENERATORS[name]
    opt = {"scale": scale,
           "network_G": {"which_model_G": name, **net, **over}}
    jm = jax_networks.define_G(opt)
    params = jax_variables(jm, *inputs)["params"]
    tm = networks.define_G(opt, device="cpu")
    return jm, params, tm, inputs


@pytest.mark.parametrize("name,scale", CASES)
def test_generator_forward_matches_jax(name, scale):
    jm, params, tm, inputs = _pair(name, scale)
    sd = from_flax(params)
    keys = {flax_path_to_torch_key(p) for p in flatten_params(params)}
    assert keys == set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    want = jm.apply({"params": params}, *inputs)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in inputs))
    tol = 2e-4
    if name in NUDGED:
        tol = max(tol, 4 * _nudge_reading(jm, params, tm, inputs, want, got))
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
    else:
        _close(got, want, tol)


# the attention variant is ill-conditioned at its init: a one-ulp move of
# the LR image moves JAX's own output by 6.6e-4 of its largest value
NUDGED = {"SFTMD_upsacle_after_ResBlk_depth"}


def _nudge_reading(jm, params, tm, inputs, want, got):
    """The larger of JAX's and the port's own output change (of the largest
    JAX output) when the LR image moves up by one ulp."""
    x = np.nextafter(inputs[0], np.float32(np.inf))
    moved = (x,) + tuple(inputs[1:])
    want_n = jm.apply({"params": params}, *moved)
    with torch.no_grad():
        got_n = tm(*(torch.from_numpy(a) for a in moved))
    first = (lambda t: t[0]) if isinstance(want, tuple) else (lambda t: t)
    w, wn = np.asarray(first(want)), np.asarray(first(want_n))
    g, gn = first(got).numpy(), first(got_n).numpy()
    top = float(np.abs(w).max())
    return max(float(np.abs(wn - w).max()), float(np.abs(gn - g).max())) / top


@pytest.mark.parametrize("n", [0, 1, 2])
def test_depth_variant_at_fewer_depth_blocks_matches_jax(n):
    """``n_depthResBlk`` 0–2, with and without the learned depth maps."""
    jm, params, tm, inputs = _pair("SFTMD_upsacle_after_ResBlk_depth", 8,
                                   n_depthResBlk=n,
                                   predict_depth_map=n == 2,
                                   use_attention=False)
    tm.load_state_dict(from_flax(params), strict=True)
    want = jm.apply({"params": params}, *inputs)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in inputs))
    if n == 2:
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert got[2] is None and want[2] is None
    else:
        _close(got, want)


def test_sftmd_demo_clip_and_corrector_residual_match_jax():
    jm, params, tm, inputs = _pair("SFTMD_DEMO", 4)
    tm.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in inputs), True)
    _close(got, jm.apply({"params": params}, *inputs, True))
    assert float(got.min()) >= 0 and float(got.max()) <= 1
    jm, params, tm, inputs = _pair("Corrector", 4)
    tm.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in inputs), res=True)
    _close(got, jm.apply({"params": params}, *inputs, res=True))


def test_rrdb_module_with_its_own_growth_matches_jax():
    from endosr.nn.rrdb import RRDBNet as JaxRRDB

    jm = JaxRRDB(nf=16, nb=1, gc=8)
    params = jax_variables(jm, X)["params"]
    tm = rrdb.RRDBNet(nf=16, nb=1, gc=8)
    tm.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        _close(tm(torch.from_numpy(X)), jm.apply({"params": params}, X))


@pytest.mark.parametrize("cls", ["PositionAttention",
                                 "PositionAttentionEfficient"])
def test_position_attention_matches_jax(cls):
    feats = RNG.standard_normal((2, 6, 5, 16)).astype(np.float32)
    depth = RNG.random((2, 6, 5, 1)).astype(np.float32)
    jm = getattr(jax_variants, cls)(in_channels=16)
    params = jax_variables(jm, feats, depth)["params"]
    tm = getattr(sftmd_variants, cls)(16, 1)
    tm.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(depth))
    _close(got, jm.apply({"params": params}, feats, depth))


@pytest.mark.parametrize("cls", ["FCN8s", "FCN16s", "FCN32s", "FCNs"])
def test_fcn_forwards_and_batch_statistics_match_jax(cls):
    from endosr.nn import fcn as jax_fcn

    x = RNG.random((2, 32, 32, 3)).astype(np.float32)
    jm = getattr(jax_fcn, cls)(n_class=2)
    variables = jax_variables(jm, x, seed=2)
    tm = getattr(t_fcn, cls)(n_class=2)
    sd = from_flax_variables(variables)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    # training mode: batch statistics, and the running ones updated
    want, new = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want)
    stats = tm.state_dict()
    for k, w in from_flax_stats(jax.tree_util.tree_map(
            np.asarray, new["batch_stats"])).items():
        if k.endswith("num_batches_tracked"):
            assert int(stats[k]) == 1
            continue
        assert torch.allclose(stats[k], w, rtol=1e-5, atol=1e-7), k
    # eval mode: the running statistics
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, jm.apply(variables, x, train=False))


def test_define_segnet_d_and_f_build():
    net = networks.define_SegNet({"network_SegNet": {"num_classes": 3}},
                                 device="cpu")
    assert type(net).__name__ == "FCN8s"
    assert net.classifier.weight.shape[0] == 3
    d = networks.define_D({"network_D": {
        "which_model_D": "discriminator_vgg_128"}}, device="cpu")
    assert type(d).__name__ == "DiscriminatorVGG128"
    assert d.linear1.weight.shape == (100, 512 * 4 * 4)   # HR 32 × 4
    with pytest.raises(NotImplementedError, match="Nope_D"):
        networks.define_D({"network_D": {"which_model_D": "Nope_D"}},
                          device="cpu")
    f = networks.define_F({}, device="cpu")
    assert type(f).__name__ == "VGGFeatureExtractor"
    assert not any(p.requires_grad for p in f.parameters())
    with pytest.raises(NotImplementedError, match="Nope"):
        networks.define_G({"network_G": {"which_model_G": "Nope"}},
                          device="cpu")


def test_generators_take_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        networks.define_G({"network_G": {"which_model_G": "MSRResNet"}})
    with pytest.raises(RuntimeError, match="CUDA"):
        networks.define_SegNet({})
    with pytest.raises(RuntimeError, match="CUDA"):
        networks.define_D({"network_D": {
            "which_model_D": "discriminator_vgg_128"}})
    with pytest.raises(RuntimeError, match="CUDA"):
        networks.define_F({})


# ------------------------------------------------------------ checkpoints

MODEL_OF = {"MSRResNet": "sr", "SFTMD": "sftmd", "Predictor": "predictor",
            "Corrector": "corrector",
            "SFTMD_upsacle_after_ResBlk_depth": "sftmd_depth"}


@pytest.mark.parametrize("name", list(MODEL_OF))
def test_seeded_pth_loads_strictly_in_both_packages(name, tmp_path):
    net, scales, inputs = GENERATORS[name]
    opt = {"model": MODEL_OF[name], "scale": scales[-1], "is_train": False,
           "network_G": {"which_model_G": name, **net}, "datasets": {}}
    src = seeded_init(networks.define_G(opt, device="cpu"), 7)
    path = str(tmp_path / "G.pth")
    torch.save(src.state_dict(), path)
    m = create_model({**opt, "path": {"pretrain_model_G": path,
                                      "strict_load": True}}, device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(m.netG.state_dict()[k], v), k
    jm = jax_networks.define_G(opt)
    template = jax.tree_util.tree_map(
        np.asarray, jax_variables(jm, *inputs)["params"])
    ported = jax_load_network(path, template, strict=True)
    for k, v in from_flax(ported).items():
        assert torch.equal(v, src.state_dict()[k]), k


def _small_depthnet_opt():
    return {"scale": 4, "datasets": {"test": {"depthMaskNum": 4}},
            "network_G": {"which_model_G": "DepthNet", "nb": 4,
                          "depth_latent_ch": 16,
                          "which_ResBlk_depth": [0, 1]}}


def test_c10_dead_reference_tensors_load_strictly(tmp_path, caplog):
    opt = _small_depthnet_opt()
    src = seeded_init(networks.define_G(opt, device="cpu"), 3)
    sd = dict(src.state_dict())
    gen = torch.Generator().manual_seed(0)
    dead = {"depth-residual14.conv1.0.weight": (64, 64, 3, 3),
            "depth-residual14.conv1.0.bias": (64,),
            "depth-residual14.norm1.mlp_mask.0.weight": (16, 4, 3, 3)}
    sd.update({k: torch.rand(s, generator=gen) for k, s in dead.items()})
    path = str(tmp_path / "latest_G.pth")
    torch.save(sd, path)
    net = seeded_init(networks.define_G(opt, device="cpu"), 4)
    with caplog.at_level(logging.INFO, logger="base"):
        BaseModel.load_network(None, path, net, strict=True)
    assert "depth-residual14.conv1.0.weight" in caplog.text
    for k, v in src.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    # the JAX package's porter reads the same file to the same weights
    jm = jax_networks.define_G(opt)
    lq = np.zeros((1, 8, 8, 3), np.float32)
    template = jax.tree_util.tree_map(np.asarray, jax_variables(
        jm, lq, np.zeros((1, 8, 8, 1), np.float32),
        np.zeros((1, 8, 8, 4), np.float32))["params"])
    ported = from_flax(jax_load_network(path, template, strict=True))
    assert set(ported) == set(src.state_dict())
    for k, v in ported.items():
        assert torch.equal(v, src.state_dict()[k]), k


def test_c10_missing_key_and_wrong_shape_still_raise(tmp_path):
    opt = _small_depthnet_opt()
    sd = dict(seeded_init(networks.define_G(opt, device="cpu"),
                          3).state_dict())
    gone = "head.0.weight_v"
    path = str(tmp_path / "G.pth")
    torch.save({k: v for k, v in sd.items() if k != gone}, path)
    net = networks.define_G(opt, device="cpu")
    with pytest.raises(KeyError, match=gone.replace(".", r"\.")):
        BaseModel.load_network(None, path, net, strict=True)
    BaseModel.load_network(None, path, net, strict=False)   # the rest loads
    assert torch.equal(net.state_dict()["conv_output.weight"],
                       sd["conv_output.weight"])
    sd["conv_output.bias"] = torch.zeros(5)
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="conv_output.bias"):
        BaseModel.load_network(None, path, net, strict=True)
