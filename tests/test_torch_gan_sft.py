"""SFT-GAN (``sftgan``), its dataset and the GAN models' files against the
JAX package's, fp32 on the CPU, on the JAX modules' own initial weights
(``from_flax_gan``); the helpers and bars are ``test_torch_gan.py``'s.

- SFT-GAN (SFTNet, ACD at HR 32, LR 8², batch 2, categories 3 and 0) at
  steps 1, 2 and 20001, each step also from JAX's whole state before it
  (weights, D's statistics, the three Adams): the first step's fp32
  gradients ≤ 2e-4 of each tensor's largest from JAX's float64 ones
  (``test_torch_gan.py``'s ``_jax_f64_grads``; ACD's conv biases before a
  BatchNorm have a zero true gradient: both fp32 ones ≤ 1e-5 of the
  largest); the
  weights after each step by ``check_updates`` (5·lr on the SFT
  parameters) and its logs; the non-SFT parameters unchanged through
  steps 1 and 2 in both and moved at 20001; ``tx_other``'s moments after
  the frozen steps within what the gradients' bar and JAX's own fp32
  distance from its float64 gradient allow them; the SFT
  mask's count (C15: 1,497,888 of 1,833,763, as in JAX); the
  cross-entropy of a background-only batch is 0 in both.
- Save and resume (``srgan`` and ``sftgan``): ``{iter}_D.pth`` and
  ``{iter}.state`` round-trip (the resumed model steps as the saved one
  does, bit for bit on one thread), and ``pretrain_model_D`` loads the
  weights and running statistics.
- ``LRHR_seg_bg`` items equal JAX's (arrays bit-equal, strings and
  categories equal) at seeds that take the background branch and seeds
  that do not, in training (rescale, crop, flips, rotations) and in
  validation.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosr.models import create_model as jax_create
from endosr.models.sftgan_model import _cross_entropy_ignore0
from endosr_torch.models import create_model
from endosr_torch.models.sftgan_model import cross_entropy_ignore0, sft_mask
from endosr_torch.utils.port_params import from_flax_gan
from tests.test_torch_gan import (B, GAN_SIDE, LR, SIDE, _as_port,
                                  _gan_state, _grad_fails, _jax_f64_grads,
                                  _jax_gan_grad_fn, _load, _logs_close,
                                  _named, _paths, _srgan_opt, _u, _weights,
                                  record_gradient_readings)
from tests.torch_models_common import check_updates, jax_model, model_opt, \
    tree_np
from tests.torch_threads import one_torch_thread  # noqa: F401


# ------------------------------------------------------------- SFT-GAN

SFT_STEPS = (1, 2, 20001)
SFT_NETS = ("ACDVGGBN96", "SFTNet")
SFT_TRAIN = {"gan_type": "gan", "gan_weight": 5e-3, "pixel_weight": 1.0,
             "feature_weight": 0, "D_update_ratio": 1, "D_init_iters": 0,
             "lr_G": LR, "lr_D": LR, "beta1_G": 0.9, "beta1_D": 0.9}


def _sft_opt():
    opt = model_opt("sftgan", {"which_model_G": "sft_arch"}, dict(SFT_TRAIN))
    opt["datasets"]["train"]["LR_size"] = SIDE
    return opt


def _sft_batch():
    return {"LR": _u(B, SIDE, SIDE, 3, seed=20),
            "GT": _u(B, 4 * SIDE, 4 * SIDE, 3, seed=21),
            "seg": _u(B, 4 * SIDE, 4 * SIDE, 8, seed=22),
            "category": np.array([3, 0], np.int64)}


def _sft_states(jm):
    return _gan_state(jm, "SFTNet", "ACDVGGBN96")


def _adam_state(state):
    """An optax ``scale_by_adam`` chain state → (count, mu, nu)."""
    adam = state[0]
    return int(adam.count), tree_np(adam.mu), tree_np(adam.nu)


def _sft_port_from(opt, batch, jm_params, jm_opt, step):
    """The port's step ``step`` from JAX's whole state (weights, D's
    statistics, the three Adams' moments and counts): (logs, G's and D's
    gradients, G's and D's weights after it, ``tx_other``'s m and v)."""
    tm = create_model(copy.deepcopy(opt), device="cpu")
    g = from_flax_gan(jm_params["netG"], "SFTNet")
    d = from_flax_gan({"params": jm_params["netD"],
                       "batch_stats": jm_params["netD_stats"]}, "ACDVGGBN96")
    _load(tm, (g, d))
    for name, tx in (("G_SFT", tm.optimizer_G.tx_sft),
                     ("G_other", tm.optimizer_G.tx_other)):
        count, mu, nu = _adam_state(jm_opt[name])
        mu, nu = from_flax_gan(mu, "SFTNet"), from_flax_gan(nu, "SFTNet")
        tx.count = count
        tx.m = [mu[k] for k in tm.g_names]
        tx.v = [nu[k] for k in tm.g_names]
    count, mu, nu = _adam_state(jm_opt["D"])
    mu = from_flax_gan(mu, "ACDVGGBN96")
    nu = from_flax_gan(nu, "ACDVGGBN96")
    if count:
        for k, p in tm.netD.named_parameters():
            tm.optimizer_D.state[p] = {"step": torch.tensor(float(count)),
                                       "exp_avg": mu[k],
                                       "exp_avg_sq": nu[k]}
    tm.step = tm.step_G = count
    tm.feed_data(batch)
    logs = dict(tm.optimize_parameters(step))
    tx = tm.optimizer_G.tx_other
    return {"logs": logs,
            "grads": (_named(tm.netG, "grad"), _named(tm.netD, "grad")),
            "params": (_named(tm.netG, "p"), _named(tm.netD, "p")),
            "other": (dict(zip(tm.g_names, tx.m)), dict(zip(tm.g_names, tx.v))),
            "model": tm}


@pytest.fixture(scope="module")
def sftgan():
    """JAX's steps 1, 2 and 20001 from its start, with each step's
    gradients in fp32 and in float64 (the yardstick); the port's from the
    same start, and each step again from JAX's state before it."""
    opt, batch = _sft_opt(), _sft_batch()
    jm = jax_model(jax_create, copy.deepcopy(opt))
    fn = _jax_gan_grad_fn(jm, seg=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"jax_states": [_sft_states(jm)], "jax_logs": [], "jax_other": [],
           "jax_grads": [], "from_jax": []}
    jm.feed_data(batch)
    before = []
    for step in SFT_STEPS:
        params, opt_state = tree_np(jm.state.params), jm.state.opt_state
        before.append(params)
        out["jax_grads"].append(_as_port(fn(params, jb), "ACDVGGBN96",
                                         "SFTNet"))
        out["from_jax"].append(_sft_port_from(opt, batch, params, opt_state,
                                              step))
        jm.optimize_parameters(step)
        out["jax_logs"].append(dict(jm.log_dict))
        out["jax_states"].append(_sft_states(jm))
        _, mu, nu = _adam_state(jm.state.opt_state["G_other"])
        out["jax_other"].append((from_flax_gan(mu, "SFTNet"),
                                 from_flax_gan(nu, "SFTNet")))
    out["jax64"] = _jax_f64_grads(jm, before, batch, True, SFT_NETS)
    out["jax_mask"] = jm._sft_param_mask
    tm = create_model(copy.deepcopy(opt), device="cpu")
    _load(tm, out["jax_states"][0])
    tm.feed_data(batch)
    out["logs"], out["states"] = [], []
    for step in SFT_STEPS:
        out["logs"].append(dict(tm.optimize_parameters(step)))
        out["states"].append((_named(tm.netG, "p"), _named(tm.netD, "p")))
    out["grads"] = out["from_jax"][0]["grads"]
    out["model"], out["jm"], out["batch"], out["opt"] = tm, jm, batch, opt
    return out


def test_sftgan_logs_match_jax(sftgan):
    r = sftgan
    keys = {"l_g_pix", "l_g_gan", "l_g_cls", "l_d_real", "l_d_fake",
            "l_d_cls_real", "l_d_cls_fake", "D_real", "D_fake"}
    for got, want in zip(r["logs"], r["jax_logs"]):
        assert set(got) == set(want) == keys
    _logs_close(r["logs"][0], r["jax_logs"][0], 1e-5, "sftgan step 1")


@pytest.mark.parametrize("net", ["G", "D"])
def test_sftgan_gradients_match_jax(sftgan, net, record_property):
    got, want = sftgan["grads"][0 if net == "G" else 1], \
        sftgan["jax_grads"][0][0 if net == "G" else 1]
    want64 = {k[2:]: v for k, v in sftgan["jax64"][0].items()
              if k[0] == net}
    assert sorted(got) == sorted(want) == sorted(want64)
    top = max(float(w.abs().max()) for w in want64.values())
    fails = []
    for k in list(want64):
        if _before_batch_norm(k):
            worst = max(float(want[k].abs().max()),
                        float(got[k].abs().max()))
            if not worst <= ZERO_GRAD * top:
                fails.append((k, worst))
            del want64[k]
    record_gradient_readings(record_property, got, want, want64)
    assert not fails + _grad_fails(got, want64), fails


# a conv bias right before a BatchNorm has a zero true gradient: both
# packages' ≤ 1e-5 of the step's largest gradient of that network
ZERO_GRAD = 1e-5


def _before_batch_norm(key):
    """ACD's ``feature`` conv biases (each conv but the first is followed
    by a BatchNorm at the next index)."""
    parts = key.split(".")
    return parts[0] == "feature" and parts[2] == "bias" and parts[1] in {
        "2", "5", "8", "11", "14", "17", "20"}


@pytest.mark.parametrize("n", range(len(SFT_STEPS)),
                         ids=[f"step{s}" for s in SFT_STEPS])
def test_sftgan_parameters_after_updates_match_jax(sftgan, n):
    """Each step from JAX's state before it: G's and D's weights after it
    by ``check_updates`` (G's SFT parameters take 5× the LR, so their
    bound is 5·lr) and its logs."""
    r = sftgan
    step = r["from_jax"][n]
    before, after = r["jax_states"][n], r["jax_states"][n + 1]
    jg, jd = r["jax_grads"][n]
    # the first update (from zero moments) by the one-update rule; a later
    # one, whose size follows the gradient's, by the several-update rule
    # (2·lr a component, 5 % of the move in norm)
    k = 1 if n == 0 else 2
    check_updates(step["params"][0], after[0], before[0], 5 * LR, k,
                  step["grads"][0], jg, f"sftgan G step {SFT_STEPS[n]}")
    check_updates(step["params"][1], _weights(after[1]), _weights(before[1]),
                  LR, k, step["grads"][1], jd, f"sftgan D step {SFT_STEPS[n]}")
    _logs_close(step["logs"], r["jax_logs"][n], 1e-5,
                f"sftgan step {SFT_STEPS[n]}")


def test_sftgan_freezes_the_other_parameters_until_20001(sftgan):
    """The non-SFT parameters (``conv0``, ``HR_branch``) stay put through
    steps 1 and 2 in both packages, and move at step 20001."""
    r = sftgan
    g0 = r["jax_states"][0][0]
    other = [k for k in g0 if not sft_mask(k)]
    assert sorted(other) == sorted(["conv0.weight", "conv0.bias"] + [
        f"HR_branch.{i}.{w}" for i in (0, 3, 6, 8) for w in ("weight", "bias")])
    for n in (1, 2):
        for k in other:
            assert torch.equal(r["states"][n - 1][0][k], g0[k])
            assert torch.equal(r["jax_states"][n][0][k], g0[k])
    for states in (r["states"][2][0], r["jax_states"][3][0]):
        assert all(not torch.equal(states[k], g0[k]) for k in other)


def test_sftgan_frozen_moments_move_as_in_jax(sftgan):
    """``tx_other`` takes every G step's gradient of all of G, the frozen
    parameters' too: after each frozen step (1, 2) from JAX's state its
    moments are JAX's. From equal moments, m = β1·m + (1 − β1)·g and
    v = β2·v + (1 − β2)·g² differ by what the two fp32 gradients do: the
    port's within the gradients' bar (2e-4 of the largest) of JAX's
    float64 gradient, JAX's its own distance from it. And they move on
    the frozen parameters."""
    r = sftgan
    b1, b2 = 0.9, 0.999
    for n in (0, 1):
        m, v = r["from_jax"][n]["other"]
        jm_, jv = r["jax_other"][n]
        gj = r["jax_grads"][n][0]
        g64 = {k[2:]: t for k, t in r["jax64"][n].items() if k[0] == "G"}
        for k in m:
            top = float(g64[k].abs().max())
            err = 2e-4 * top + float((gj[k].double() - g64[k]).abs().max())
            assert float((m[k] - jm_[k]).abs().max()) <= (1 - b1) * err \
                * (1 + 1e-3) + 1e-12, (n, k)
            assert float((v[k] - jv[k]).abs().max()) <= (1 - b2) * err * (
                2 * top + err) * (1 + 1e-3) + 1e-18, (n, k)
    m1, m2 = r["jax_other"][0][0], r["jax_other"][1][0]
    assert not torch.equal(m1["conv0.weight"], m2["conv0.weight"])
    tx = r["model"].optimizer_G
    assert all(torch.equal(a, b) for a, b in zip(tx.tx_other.m, tx.tx_sft.m))


def test_sft_mask_copies_jax_c15(sftgan):
    r = sftgan
    tm = r["model"]
    n_sft = sum(p.numel() for k, p in tm.netG.named_parameters()
                if sft_mask(k))
    jax_flags = jax.tree_util.tree_leaves(r["jax_mask"])
    jax_sizes = [int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(
        r["jm"].state.params["netG"])]
    assert n_sft == sum(s for f, s in zip(jax_flags, jax_sizes) if f) \
        == 1_497_888
    assert sum(p.numel() for p in tm.netG.parameters()) == 1_833_763
    # the residual blocks' convs are SFT here (the reference: "other")
    assert sft_mask("sft_branch.3.conv0.weight")
    assert not sft_mask("HR_branch.0.weight")


def test_background_only_cross_entropy_is_zero():
    logits = _u(3, 8, seed=23)
    labels = np.zeros(3, np.int64)
    assert float(cross_entropy_ignore0(torch.from_numpy(logits),
                                       torch.from_numpy(labels))) == 0.0
    assert float(_cross_entropy_ignore0(jnp.asarray(logits),
                                        jnp.asarray(labels))) == 0.0
    labels = np.array([2, 0, 7])
    want = float(_cross_entropy_ignore0(jnp.asarray(logits),
                                        jnp.asarray(labels)))
    got = float(cross_entropy_ignore0(torch.from_numpy(logits),
                                      torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_sftgan_serves(sftgan):
    tm = sftgan["model"]
    tm.feed_data({k: v for k, v in sftgan["batch"].items() if k != "GT"},
                 need_GT=False)
    sr = tm.test()
    assert sr.shape == (B, 4 * SIDE, 4 * SIDE, 3)
    assert set(tm.get_current_visuals()) == {"SR", "LR"}


# ------------------------------------------------------ files and resume

@pytest.mark.parametrize("model", ["srgan", "sftgan"])
def test_save_and_resume_round_trip(tmp_path, model):
    if model == "srgan":
        opt, batch = _srgan_opt("ragan"), {
            "LQ": _u(B, GAN_SIDE, GAN_SIDE, 3, seed=24),
            "GT": _u(B, 4 * GAN_SIDE, 4 * GAN_SIDE, 3, seed=25)}
    else:
        opt, batch = _sft_opt(), _sft_batch()
    opt["path"] = _paths(tmp_path)
    tm = create_model(copy.deepcopy(opt), device="cpu")
    tm.feed_data(batch)
    for step in (1, 2):
        tm.optimize_parameters(step)
    tm.save(2)
    tm.save_training_state(0, 2)
    again = create_model(copy.deepcopy(opt), device="cpu")
    again.resume_training(str(tmp_path / "state" / "2.state"))
    again.feed_data(batch)
    for step in (3, 4):
        assert tm.optimize_parameters(step) == again.optimize_parameters(step)
    for a, b in ((tm.netG, again.netG), (tm.netD, again.netD)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(v, w), k
    assert again.step == 4 and again.step_G == tm.step_G
    # the weight files load as pretrained networks, running statistics too
    loaded = create_model(dict(copy.deepcopy(opt), path=dict(
        opt["path"], pretrain_model_G=str(tmp_path / "models/2_G.pth"),
        pretrain_model_D=str(tmp_path / "models/2_D.pth"))), device="cpu")
    saved = torch.load(tmp_path / "models/2_D.pth", weights_only=True)
    assert any("running_var" in k for k in saved)
    for k, v in loaded.netD.state_dict().items():
        assert torch.equal(v, saved[k]), k


# ------------------------------------------------------------ LRHR_seg_bg

CATS = ("building", "plant", "sky", "other")


@pytest.fixture(scope="module")
def seg_tree(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("segbg")
    rng = np.random.default_rng(30)
    for sub in ("hr", "bg", "seg"):
        (root / sub).mkdir()
    for i, cat in enumerate(CATS):
        h, w = 56 + 8 * i, 64 + 4 * i
        cv2.imwrite(str(root / "hr" / f"{cat}_{i}.png"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        if cat != "other":       # the last image has no seg file
            seg = rng.random((h, w, 8)).astype(np.float32)
            np.save(root / "seg" / f"{cat}_{i}.npy", seg / seg.sum(-1,
                                                                    keepdims=True))
    for i in range(2):
        cv2.imwrite(str(root / "bg" / f"bg_{i}.png"),
                    rng.integers(0, 256, (60, 52, 3), dtype=np.uint8))
    return root


def _seg_opt(root, phase):
    return {"mode": "LRHR_seg_bg", "phase": phase, "scale": 4,
            "GT_size": 24, "use_flip": True, "use_rot": True,
            "dataroot_GT": str(root / "hr"), "dataroot_GT_bg": str(root / "bg"),
            "dataroot_seg": str(root / "seg"), "data_type": "img"}


def _bg_seeds():
    import random

    bg = [s for s in range(200) if random.Random(s).randrange(10) == 0][:2]
    fg = [s for s in range(200) if random.Random(s).randrange(10) != 0][:3]
    return bg, fg


@pytest.mark.parametrize("phase", ["train", "val"])
def test_lrhr_seg_bg_items_match_jax(seg_tree, phase):
    import random

    from endosr.data.datasets import LRHRSegBGDataset as JaxSegBG
    from endosr_torch.data import create_dataset

    opt = _seg_opt(seg_tree, phase)
    ds, jds = create_dataset(dict(opt)), JaxSegBG(dict(opt))
    assert type(ds).__name__ == "LRHRSegBGDataset"
    assert len(ds) == len(jds) == len(CATS)
    bg, fg = _bg_seeds()
    took_bg = set()
    for seed in bg + fg:
        for index in range(len(CATS)):
            ds.rng, jds.rng = random.Random(seed), random.Random(seed)
            got, want = ds[index], jds[index]
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                if isinstance(w, np.ndarray):
                    assert got[k].dtype == w.dtype and np.array_equal(
                        got[k], w), (seed, index, k)
                else:
                    assert got[k] == w, (seed, index, k)
            took_bg.add("/bg/" in got["HR_path"])
            if phase == "val":
                assert got["category"] == -1
    assert took_bg == ({True, False} if phase == "train" else {False})
