"""The depth + segmentation co-training model (``sftmd_depthSegNet``,
``models/f_depthseg.py``) against the JAX package's, fp32 on the CPU,
from the JAX model's own initial weights (netG, the dynamic loss's
K-vector, the FCN8s and its BatchNorm statistics, carried by
``from_flax_seg_train``). DepthNet nb 4 (one depth block), latent 16,
K 4, ×4 from LR 8² (so the FCN sees 32²), batch 2; the SSIM, static mask
and dynamic mask losses on; the FCN's optimiser with weight decay,
momentum 0.9 and the reference's ``setp_size`` 2 (its LR halves at the
third update).

- the logs of three steps (``l_segBCE`` among them) to ≤ 1e-5 relative
  (the first) and 2e-4 (the next two);
- the first step's gradients of netG, dyn and the FCN to ≤ 2e-4 of each
  tensor's largest (a depth block's conv biases before its InstanceNorm:
  both ≤ 1e-7 of the largest gradient);
- the parameters after 1 and 3 updates by ``check_updates``: Adam's
  per-update bound lr for netG and dyn; for the FCN the chain's, 10·lr
  (√ of ν's first step, (1 − 0.99)·g²) summed over the momentum's trace;
- the FCN's running statistics after 1 and 3 steps to ``segNet_stats``
  (≤ 1e-5 of each tensor's largest after one step; after three, when
  the parameters have drifted by Adam's ±lr steps as above, 1e-2,
  measured ≤ 1.5e-3).

Also: ``RMSChain`` against optax's chain alone (1 and 3 updates, with and
without weight decay and momentum); a uint8 batch goes in unnormalized, as
in JAX (C14); save and resume with the second network; and C11: FCN8s on a
whole CVC-ColonDB frame (574×500) fails at the first skip in both
packages (17×15 → 34×30 against the pool's 35×31), traced without
computing; and the JAX porter cannot read an FCN checkpoint (its
transposed-conv rule does not list ``deconv1``–``deconv5``; C12) where
the port's reads it.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from endosr.models.f_depthseg import FModelDepthSeg as JaxModel
from endosr.nn.fcn import FCN8s as JaxFCN8s
from endosr.parallel.mesh import make_mesh
from endosr.utils.port_torch import port_state_dict
from endosr_torch.models.f_depthseg import FModelDepthSeg, RMSChain
from endosr_torch.nn.fcn import FCN8s
from endosr_torch.utils.port_params import (from_flax, from_flax_seg_train,
                                            seeded_init)
from tests.test_torch_generators import jax_variables
from tests.torch_models_common import (check_updates, grad_rel, jax_loss_fn,
                                       jax_model, model_opt, quick_flax_init,
                                       tree_np)
from tests.torch_threads import one_torch_thread  # noqa: F401

K, LR_HW, SCALE, B, STEPS = 4, 8, 4, 2, 3
LR_G, LR_SEG, MOM = 1e-4, 1e-4, 0.9
NET = {"which_model_G": "DepthNet", "nb": 4, "depth_latent_ch": 16,
       "which_ResBlk_depth": [0], "use_trainable_params": True}
TRAIN = {"lr_G": LR_G, "weight_decay_G": 1e-3,
         "ssim_loss": {"use_ssim_criterion": True, "ssim_weight": 0.3},
         "mask_loss": {"use_mask_criterion": True,
                       "mask_criterion": "smoothl1", "mask_weight": 2.0},
         "dynamic_loss": {"use_dynamic_criterion": True,
                          "dynamic_criterion": "smoothl1",
                          "dynamic_weight": 10.0},
         "segNet": {"lr": LR_SEG, "momentum": MOM, "weight_decay": 1e-4,
                    "setp_size": 2, "gamma": 0.5}}


def _opt():
    opt = model_opt("sftmd_depthSegNet", dict(NET), TRAIN, scale=SCALE,
                    network_SegNet={"num_classes": 2})
    opt["datasets"]["train"].update(depthMaskNum=K, LR_size=LR_HW)
    return opt


def _batch(seed=11):
    rng = np.random.default_rng(seed)
    hr = LR_HW * SCALE
    seg = rng.random((B, hr, hr)) > 0.5
    return {"LQ": rng.random((B, LR_HW, LR_HW, 3), dtype=np.float32),
            "GT": rng.random((B, hr, hr, 3), dtype=np.float32),
            "Depth": rng.random((B, LR_HW, LR_HW, 1), dtype=np.float32),
            "DepthMaskList": (rng.random((B, LR_HW, LR_HW, K)) > 0.6
                              ).astype(np.float32),
            "SegLabel": np.stack([~seg, seg], -1).astype(np.float32)}


def _trainable(tree):
    return {k: tree[k] for k in ("netG", "dyn", "segNet")}


@pytest.fixture(scope="module")
def run():
    opt = _opt()
    jm = jax_model(JaxModel, copy.deepcopy(opt))
    p0 = tree_np(jm.state.params)
    batch = _batch()
    first_bin = np.random.default_rng(0).integers(0, K)
    grads, _ = jax.jit(jax.grad(jax_loss_fn(jm), has_aux=True))(
        _trainable(jm.state.params), jm.state.params["segNet_stats"],
        dict(batch, mask_bin=np.int32(first_bin)))
    out = {"grads_jax": from_flax_seg_train(tree_np(grads)), "logs_jax": [],
           "params_jax": {}, "logs": [], "params": {}}
    jm.feed_data(batch)
    for n in range(1, STEPS + 1):
        jm.optimize_parameters(n)
        out["logs_jax"].append(dict(jm.log_dict))
        out["params_jax"][n] = from_flax_seg_train(tree_np(jm.state.params))

    tm = FModelDepthSeg(copy.deepcopy(opt), device="cpu")
    start = from_flax_seg_train(p0)
    _load(tm, start)
    tm.feed_data(batch)
    for n in range(1, STEPS + 1):
        out["logs"].append(dict(tm.optimize_parameters(n)))
        if n == 1:
            out["grads"] = {k: p.grad.clone()
                            for k, p in _named(tm) if p.grad is not None}
        out["params"][n] = _state(tm)
    out.update(start=start, model=tm, opt=opt, batch=batch)
    return out


def _named(tm):
    yield from tm.named_train_parameters()
    yield from tm.named_seg_parameters()


def _state(tm):
    out = {k: p.detach().clone() for k, p in _named(tm)}
    out.update({f"segNet.{k}": v.clone()
                for k, v in tm.segNet.named_buffers()})
    return out


def _load(tm, tree):
    with torch.no_grad():
        for name, p in tm.named_train_parameters():
            p.copy_(tree[name])
    tm.segNet.load_state_dict(
        {k[len("segNet."):]: v for k, v in tree.items()
         if k.startswith("segNet.")}, strict=True)


def test_logs_match_jax(run):
    for n, (got, want) in enumerate(zip(run["logs"], run["logs_jax"])):
        assert sorted(got) == sorted(want)
        tol = 1e-5 if n == 0 else 2e-4
        for k, v in want.items():
            assert abs(got[k] - v) <= tol * max(abs(v), 1e-12), \
                f"step {n + 1} {k}: {got[k]} vs {v}"
    assert {"l_segBCE", "l_all", "l_mask", "l_ssim",
            "l_dynamic"} <= set(run["logs"][0])


def _before_instance_norm(key):
    return key.startswith("netG.depth-residual") and key.endswith(
        (".conv1.0.bias", ".conv2.0.bias"))


def test_gradients_match_jax(run):
    got, want = run["grads"], run["grads_jax"]
    assert sorted(got) == sorted(want)
    assert any(k.startswith("segNet.") for k in got)
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        if _before_instance_norm(k):
            assert max(float(w.abs().max()), float(got[k].abs().max())) \
                <= 1e-7 * top, k
            continue
        assert grad_rel(got[k], w) <= 2e-4, (k, grad_rel(got[k], w))


@pytest.mark.parametrize("n", [1, STEPS])
def test_parameters_after_updates_match_jax(run, n):
    got, want, start = run["params"][n], run["params_jax"][n], run["start"]
    grads, grads_jax = run["grads"], run["grads_jax"]
    for part, lr, wd in (
            ("netG.", LR_G, TRAIN["weight_decay_G"]),
            ("dyn.", LR_G, TRAIN["weight_decay_G"]),
            ("segNet.", 10 * LR_SEG * (1 + MOM + MOM ** 2),
             TRAIN["segNet"]["weight_decay"])):
        keys = [k for k in grads_jax if k.startswith(part)]
        check_updates(got, {k: want[k] for k in keys}, start, lr, n, grads,
                      grads_jax, part, wd=wd)


@pytest.mark.parametrize("n", [1, STEPS])
def test_batch_statistics_match_jax(run, n):
    tol = 1e-5 if n == 1 else 1e-2
    got, want = run["params"][n], run["params_jax"][n]
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 10
    for k in names:
        err = float((got[k] - want[k]).abs().max())
        assert err <= tol * float(want[k].abs().max()), (k, err)
        assert not torch.equal(got[k], run["start"][k]), k


@pytest.mark.parametrize("wd,mom", [(0.0, 0.0), (1e-2, 0.9)])
def test_rms_chain_is_the_jax_chain(wd, mom):
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((6, 7)).astype(np.float32)
    gs = [rng.standard_normal((6, 7)).astype(np.float32) * s
          for s in (1.0, 1e-3, 3.0)]
    chain = [optax.add_decayed_weights(wd)] if wd else []
    chain.append(optax.scale_by_rms(decay=0.99, eps=1e-8))
    if mom:
        chain.append(optax.trace(decay=mom))
    chain.append(optax.scale_by_learning_rate(lambda c: 1e-3 * 0.5 ** c))
    tx = optax.chain(*chain)
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = RMSChain([p], lr=1e-3, momentum=mom, weight_decay=wd)
    for n, g in enumerate(gs):
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.param_groups[0]["lr"] = 1e-3 * 0.5 ** n
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=2e-6, atol=1e-7)
    # torch's RMSprop is another update (ε outside the root, its α)
    q = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    rms = torch.optim.RMSprop([q], lr=1e-3, alpha=0.99, eps=1e-8,
                              momentum=mom, weight_decay=wd)
    q.grad = torch.from_numpy(gs[1])
    rms.step()
    p2 = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt2 = RMSChain([p2], lr=1e-3, momentum=mom, weight_decay=wd)
    p2.grad = torch.from_numpy(gs[1])
    opt2.step()
    assert not torch.allclose(q, p2, rtol=1e-4)


def test_uint8_batch_steps_unnormalized_as_in_jax(run):
    """C14: JAX's co-training step feeds a uint8 batch to the networks and
    the losses as it comes, 0–255 (``endosr/models/f_depthseg.py``'s
    ``loss_fn``; this module's JAX model gives l_pix 127.8 on the uint8
    batch against 0.50 on its [0, 1] twin); the port's does too: its uint8
    step equals its step on the same values as float32."""
    opt, batch = run["opt"], run["batch"]
    lq = np.round(batch["LQ"] * 255).astype(np.uint8)
    gt = np.round(batch["GT"] * 255).astype(np.uint8)
    logs = []
    for u8 in (True, False):
        tm = FModelDepthSeg(copy.deepcopy(opt), device="cpu")
        _load(tm, run["start"])
        cast = (lambda a: a) if u8 else (lambda a: a.astype(np.float32))
        tm.feed_data(dict(batch, LQ=cast(lq), GT=cast(gt),
                          DepthMaskList=cast(
                              batch["DepthMaskList"].astype(np.uint8))))
        logs.append(tm.optimize_parameters(1))
    assert logs[0] == logs[1]
    assert logs[0]["l_pix"] > 50


def test_save_and_resume_with_the_segmentation_network(run, tmp_path):
    opt = copy.deepcopy(run["opt"])
    opt["path"] = {"models": str(tmp_path / "models"),
                   "training_state": str(tmp_path / "state")}
    tm = FModelDepthSeg(copy.deepcopy(opt), device="cpu")
    _load(tm, run["start"])
    tm.feed_data(run["batch"])
    tm.optimize_parameters(1)
    tm.save(1)
    path = tm.save_training_state(0, 1)
    assert (tmp_path / "models" / "1_segNet.pth").is_file()
    assert (tmp_path / "models" / "1_G.pth").is_file()
    st = torch.load(path, weights_only=True)
    assert {"segNet", "optimizer_seg", "dyn_weight"} <= set(st)
    back = FModelDepthSeg(copy.deepcopy(opt), device="cpu")
    back.resume_training(path)
    back.feed_data(run["batch"])
    # the mask loss's bin RNG is not saved (as in JAX): take the run's
    back._np_rng = copy.deepcopy(tm._np_rng)
    tm.optimize_parameters(2)
    back.optimize_parameters(2)
    for (k, a), (_, b) in zip(_state(tm).items(), _state(back).items()):
        assert torch.equal(a, b), k
    saved = torch.load(tmp_path / "models" / "1_segNet.pth",
                       weights_only=True)
    fresh = FCN8s(n_class=2)
    fresh.load_state_dict(saved, strict=True)


def test_c11_whole_colondb_frame_fails_in_both_packages():
    x = np.zeros((1, 574, 500, 3), np.float32)
    with pytest.raises((TypeError, ValueError), match=r"34, 30|35, 31"):
        jax.eval_shape(lambda: JaxFCN8s().init(jax.random.PRNGKey(0), x))
    net = FCN8s().to("meta")
    with pytest.raises(RuntimeError, match="35|34"):
        net(torch.empty(1, 574, 500, 3, device="meta"))
    # CVC-ClinicDB's 384×288 frames (multiples of 32) go through
    out = net(torch.empty(1, 384, 288, 3, device="meta"))
    assert tuple(out.shape) == (1, 384, 288, 2)


def test_c12_jax_porter_cannot_read_an_fcn_checkpoint():
    x = np.zeros((1, 32, 32, 3), np.float32)
    template = jax.tree_util.tree_map(
        np.asarray, jax_variables(JaxFCN8s(), x)["params"])
    src = seeded_init(FCN8s(), 0)
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        port_state_dict(sd, template, strict=True)
    # the port's own round trip: its keys and layouts are JAX's tree's
    back = FCN8s()
    back.load_state_dict(src.state_dict(), strict=True)
    assert set(from_flax(template)) <= set(back.state_dict())


def test_jaccard_and_bce_match_jax():
    from endosr.models.f_depthseg import _bce_with_logits, jaccard_loss

    from endosr_torch.models.f_depthseg import (bce_with_logits,
                                                jaccard_loss as t_jaccard)

    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((2, 8, 6, 2)) * 3).astype(np.float32)
    seg = rng.random((2, 8, 6)) > 0.5
    onehot = np.stack([~seg, seg], -1).astype(np.float32)
    for got, want in (
            (t_jaccard(torch.from_numpy(onehot), torch.from_numpy(logits)),
             jaccard_loss(onehot, logits)),
            (bce_with_logits(torch.from_numpy(logits),
                             torch.from_numpy(onehot)),
             _bce_with_logits(logits, onehot))):
        assert float(got) == pytest.approx(float(want), rel=1e-6)
