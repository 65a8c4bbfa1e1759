"""The port's training step with the depth and VGG losses on, against the
JAX package's, on the CPU.

``FModelDepthCond`` with ``is_train`` at the ×8 smoke configuration of
``tests/test_torch_train.py`` (LR 16 → GT 128, nb 4, K 4, latent 16,
batch 2, fp32) on the flagship recipe (the ×8 YAML's ``train:`` block)
with ``use_depth_criterion`` and ``use_vgg_criterion`` turned on: seeded
monodepth2 files (feed 64×96) under ``pretrained_model_path``, every scale
weighted (``depth_weight`` [0.1, 0.05, 0.02, 0.01]; the YAML weighs scale
0 alone), and a seeded torchvision VGG19 file at ``vgg_weights_path``.
The weights come from the JAX model (``from_flax_train``); the JAX
gradient and logs from its train step's own ``loss_fn``, its dump from
``_dump_disparities``, which its step 0 runs.

- The first step's logs (``l_pix``, ``l_depth``, ``l_depth_0..3``,
  ``l_vgg``, ``l_vgg_0..3``, the rest of the recipe's) ≤ 2e-6 relative.
- Every gradient ≤ 2e-4 of the largest gradient magnitude, and each
  tensor ≤ 2e-4 of its own largest magnitude + 4× the port's own change
  with oneDNN's convolutions off (the SEAN blend factors are sums that
  cancel), as ``tests/test_torch_train.py`` holds them; the conv biases
  before an InstanceNorm (a zero true gradient) ≤ 1e-7 of the largest on
  both sides.
- ``_dump_disparities`` at step 0 writes the same 8 arrays as JAX's
  (``./tmp/{sr,hr}_<i>.npy``, NHWC) ≤ 1e-5 abs.
- The frozen networks are in no optimizer group and no saved ``.pth``,
  take no gradient, and stay in ``eval()`` through ``netG.train()``.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from endosr.models.f_depthcond import FModelDepthCond as JaxModel
from endosr.parallel.mesh import make_mesh
from endosr_torch.models.f_depthcond import FModelDepthCond
from endosr_torch.models.recipes import x8_train_opt
from endosr_torch.utils.port_params import (from_flax_train,
                                            write_seeded_monodepth,
                                            write_seeded_vgg)
from tests.torch_threads import one_torch_thread  # noqa: F401

NET = {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3, "nf": 64,
       "nb": 4, "depth_latent_ch": 16, "which_ResBlk_depth": [0],
       "use_trainable_params": True}
K, LR, SCALE, B = 4, 16, 8, 2
LOSS_KEYS = {"l_pix", "l_depth", "l_vgg",
             *(f"l_{n}_{i}" for n in ("depth", "vgg") for i in range(4))}


def _opt(root):
    train = copy.deepcopy(x8_train_opt()["train"])
    train["depth_loss"].update(use_depth_criterion=True,
                               pretrained_model_path=os.path.join(root, "md"),
                               depth_weight=[0.1, 0.05, 0.02, 0.01])
    train["vgg_loss"].update(use_vgg_criterion=True,
                             vgg_weights_path=os.path.join(root, "vgg19.pth"))
    return {"is_train": True, "model": "sftmd_depthCond", "scale": SCALE,
            "precision": None,
            "datasets": {"train": {"depthMaskNum": K, "LR_size": LR}},
            "network_G": dict(NET), "path": {}, "train": train}


def _batch(seed=11):
    rng = np.random.default_rng(seed)
    return {"LQ": rng.random((B, LR, LR, 3), dtype=np.float32),
            "GT": rng.random((B, LR * SCALE, LR * SCALE, 3), dtype=np.float32),
            "Depth": rng.random((B, LR, LR, 1), dtype=np.float32),
            "DepthMaskList": (rng.random((B, LR, LR, K)) > 0.6).astype(
                np.float32)}


def _jax_loss_fn(jm):
    """The JAX train step's own loss function (from its closure)."""
    step = jm._train_step.__wrapped__
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    return cells["loss_fn"]


def _log_dict(logs):
    """The loss function's logs as the JAX model's ``log_dict`` holds them
    (the dynamic loss's vectors one value a bin)."""
    out = {}
    for k, v in logs.items():
        v = np.asarray(v)
        if v.ndim:
            out.update({f"{k}_{i}": float(x) for i, x in enumerate(v)})
        else:
            out[k] = float(v)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One JAX and one port model from the same weights, their first
    step's gradients and logs, and the disparity dumps of step 0."""
    root = str(tmp_path_factory.mktemp("losses"))
    write_seeded_monodepth(os.path.join(root, "md"), seed=1, height=64,
                           width=96)
    write_seeded_vgg(os.path.join(root, "vgg19.pth"), seed=2)
    opt = _opt(root)
    batch = _batch()
    jm = JaxModel(copy.deepcopy(opt), mesh=make_mesh(jax.devices()[:1]))
    p0 = jax.tree_util.tree_map(np.asarray, jm.state.params)
    first_bin = np.random.default_rng(opt["train"]["manual_seed"]).integers(
        0, K)
    grads, logs = jax.jit(jax.grad(_jax_loss_fn(jm), has_aux=True))(
        jm.state.params, dict(batch, mask_bin=np.int32(first_bin)))
    out = {"grads_jax": from_flax_train(jax.tree_util.tree_map(np.asarray,
                                                                grads)),
           "logs_jax": _log_dict(logs), "root": root}
    cwd = os.getcwd()
    try:
        for name in ("jax", "port"):
            os.makedirs(os.path.join(root, name))
        os.chdir(os.path.join(root, "jax"))
        jm._dump_disparities(batch)     # what optimize_parameters(0) runs
        tm = FModelDepthCond(copy.deepcopy(opt), device="cpu")
        start = from_flax_train(p0)
        with torch.no_grad():
            for k, p in tm.named_train_parameters():
                p.copy_(start[k])
        tm.feed_data(batch)
        os.chdir(os.path.join(root, "port"))
        out["logs"] = dict(tm.optimize_parameters(0))
    finally:
        os.chdir(cwd)
    out["grads"] = {k: p.grad.clone() for k, p in tm.named_train_parameters()}
    out["model"] = tm
    # the rounding scale of each gradient: the port's own first gradient
    # once more with oneDNN's convolutions off (other summation orders)
    again = FModelDepthCond(copy.deepcopy(opt), device="cpu")
    with torch.no_grad():
        for k, p in again.named_train_parameters():
            p.copy_(start[k])
    again.feed_data(batch)
    with torch.backends.mkldnn.flags(enabled=False):
        again.optimize_parameters()
    out["noise"] = {k: float((p.grad - out["grads"][k]).abs().max())
                    for k, p in again.named_train_parameters()}
    return out


def test_logs_match_jax(run):
    got, want = run["logs"], run["logs_jax"]
    assert sorted(got) == sorted(want)
    assert LOSS_KEYS <= set(got)
    for k, v in want.items():
        assert abs(got[k] - v) <= 2e-6 * max(abs(v), 1e-12), \
            f"{k}: {got[k]} vs {v}"
    assert all(got[f"l_depth_{i}"] > 0 and got[f"l_vgg_{i}"] > 0
               for i in range(4))


def _before_instance_norm(key):
    return key.startswith("netG.depth-residual") and key.endswith(
        (".conv1.0.bias", ".conv2.0.bias"))


def test_gradients_match_jax(run):
    got, want = run["grads"], run["grads_jax"]
    assert sorted(got) == sorted(want)
    top = max(float(g.abs().max()) for g in want.values())
    for k, w in want.items():
        if _before_instance_norm(k):
            assert max(float(w.abs().max()), float(got[k].abs().max())) \
                <= 1e-7 * top, k
            continue
        err = float((got[k] - w).abs().max())
        assert err <= 2e-4 * top, f"{k}: max |Δ| {err:.3g} of {top:.3g}"
        tol = 2e-4 * float(w.abs().max()) + 4 * run["noise"][k]
        assert err <= tol, f"{k}: max |Δ| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("tag", ["sr", "hr"])
def test_disparity_dump_matches_jax(run, tag):
    for i in range(4):
        a = np.load(os.path.join(run["root"], "jax", "tmp", f"{tag}_{i}.npy"))
        b = np.load(os.path.join(run["root"], "port", "tmp", f"{tag}_{i}.npy"))
        assert b.shape == a.shape == (B, 64 >> i, 96 >> i, 1)
        assert np.abs(a - b).max() <= 1e-5, (tag, i)
    assert sorted(os.listdir(os.path.join(run["root"], "port", "tmp"))) == \
        sorted(os.listdir(os.path.join(run["root"], "jax", "tmp")))


def test_dump_only_every_1000th_step(run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tm = run["model"]
    tm.feed_data(_batch(12))
    tm.optimize_parameters(999)
    tm.optimize_parameters(None)
    assert not os.path.exists("tmp")
    tm.optimize_parameters(2000)
    assert len(os.listdir("tmp")) == 8


def test_frozen_networks_stay_out_of_training(run, tmp_path):
    tm = run["model"]
    frozen = [tm.depth_loss_fn.encoder, tm.depth_loss_fn.decoder,
              tm.vgg_loss_fn.model]
    frozen_ids = {id(p) for net in frozen for p in net.parameters()}
    in_opt = {id(p) for g in tm.optimizer_G.param_groups for p in g["params"]}
    assert frozen_ids and not frozen_ids & in_opt
    assert in_opt == {id(p) for _, p in tm.named_train_parameters()}
    tm.netG.train()
    for net in frozen:
        assert not net.training
        assert all(p.grad is None and not p.requires_grad
                   for p in net.parameters())
    tm.opt["path"]["models"] = str(tmp_path)
    saved = torch.load(tm.save(5), weights_only=True)
    assert list(saved) == list(tm.netG.state_dict())
