"""The GAN models of the port (``srgan``, ``sftgan``), their networks,
losses and dataset against the JAX package's, fp32 on the CPU, on the JAX
modules' own initial weights (``from_flax`` / ``from_flax_gan``):

- ``gan_loss``, every type × both targets, ≤ 1e-6 relative;
  ``gradient_penalty`` on JAX's α: the value and its gradient with
  respect to the critic's weights ≤ 1e-5 relative (of the largest).
- ``DiscriminatorVGG128`` (nf 8, HR 32) and ``ACDVGGBN96`` (HR 32) in
  train and eval mode: outputs ≤ 2e-4 of max |ref|; the running
  statistics after a training forward ≤ 1e-6 (absolute, of values
  ≤ 1); under ``batch_stats_only`` they stay as they were.
- ``SFTNet`` and ``SFTNetTorch`` (full width, LR 8², seg 32²) ≤ 2e-4.
- SRGAN (MSRResNet nf 16 nb 1 ×4, D nf 8, LR 16², batch 2,
  ``D_update_ratio`` 2: steps 1 and 3 D only, 2 and 4 G + D) for
  ``gan``, ``lsgan`` and ``wgan-gp`` (no penalty, C16); ``ragan`` with
  the VGG feature loss runs the same checks in
  ``tests/test_torch_gan_ragan.py``:
  - the keys of each gate's logs; step 1's pixel and feature losses
    ≤ 1e-5 relative, the logs computed from D's logits (the GAN terms,
    ``D_real`` / ``D_fake``) ≤ 2e-4, the outputs' bar;
  - from JAX's state after step 1, the port's step 2 (G + D): its logs
    to the same bars; G's and D's fp32 gradients (D's on the fake of G
    before its update) against JAX's own float64 gradients of the step
    (``g_loss_fn`` / ``d_loss_fn`` with the networks at ``dtype=float64``
    and the fp32 the JAX modules name read as float64): ≤ 2e-4 of each
    tensor's largest + 4× the port's own difference with oneDNN's
    convolutions off (JAX's fp32 gradients of D's BatchNorm layers sit up
    to 4.2 % of their largest from JAX's float64 ones; the port's ≤ 1e-5);
  - D's running statistics after that step ≤ 1e-6 of JAX's (two updates,
    GT then fake: a third, from G's forward, would move them by far more);
  - the parameters after 1 and all updates of G and of D
    (``check_updates``: Adam's ±lr bound where two gradients straddle 0;
    a component is held closer only where JAX's gradient exceeds 10× the
    two packages' difference; after all updates within 25 % of JAX's
    move, ``FRAC_ALL``).
- JAX's ``load_network`` reads the port's ``_D.pth`` to the same weights
  with the reference names as its key function; with its default key
  function it cannot (C17: ``conv0_0`` is read as ``conv0.0``), and it
  cannot read an SFTNet checkpoint (``CondNet.0`` is looked up as
  ``CondNet.CondNet.0``).
- C18: G's Adam reads ``beta1`` / ``beta2``, as JAX's, not ``beta1_G``.

SFT-GAN, ``LRHR_seg_bg`` and the saved files: ``tests/test_torch_gan_sft.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import endosr.models.sftgan_model as jax_sftgan_model
import endosr.nn.discriminator as jax_discriminator
import endosr.nn.layers as jax_layers
import endosr.nn.sft_arch as jax_sft_arch
import endosr.nn.srresnet as jax_srresnet
import endosr.ops.resize as jax_resize
from endosr.losses.basic import gan_loss as jax_gan_loss
from endosr.losses.basic import gradient_penalty as jax_gp
from endosr.models import create_model as jax_create
from endosr.nn.discriminator import DiscriminatorVGG128 as JaxD128
from endosr.nn.sft_arch import ACDVGGBN96 as JaxACD
from endosr.nn.sft_arch import SFTNet as JaxSFTNet
from endosr.nn.sft_arch import SFTNetTorch as JaxSFTNetTorch
from endosr_torch.losses.basic import gan_loss, gradient_penalty
from endosr_torch.models import create_model
from endosr_torch.nn.discriminator import DiscriminatorVGG128
from endosr_torch.nn.fcn import batch_stats_only
from endosr_torch.nn.sft_arch import ACDVGGBN96, SFTNet, SFTNetTorch
from endosr_torch.utils.port_params import from_flax, from_flax_gan
from tests.test_torch_generators import jax_variables
from tests.torch_models_common import (check_updates, jax_model, model_opt,
                                       tree_np)
from tests.torch_threads import one_torch_thread  # noqa: F401

LR, B, SIDE, STEPS = 1e-4, 2, 8, 4
# SRGAN's LR side: at HR 64 D's last BatchNorms see 2·2·2 values a
# channel (at HR 32 two, which they normalize to ±1 whatever the input, so
# the gradient through them is left to the ε terms)
GAN_SIDE = 16
RNG = np.random.default_rng(17)


def _u(*shape, seed=None):
    rng = RNG if seed is None else np.random.default_rng(seed)
    return rng.random(shape).astype(np.float32)


def _rel(got, want):
    w = np.asarray(want, np.float64)
    g = got.detach().double().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float64)
    assert g.shape == w.shape
    return float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("target", [True, False])
@pytest.mark.parametrize("gan_type", ["gan", "ragan", "lsgan", "wgan-gp"])
def test_gan_loss_matches_jax(gan_type, target):
    pred = (_u(4, 1, seed=1) - 0.5) * 6
    want = float(jax_gan_loss(gan_type, jnp.asarray(pred), target))
    got = float(gan_loss(gan_type, torch.from_numpy(pred), target))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), (got, want)


def test_unknown_gan_type_raises():
    with pytest.raises(NotImplementedError, match="nope"):
        gan_loss("nope", torch.zeros(2, 1), True)


def test_gradient_penalty_matches_jax():
    real, fake = _u(3, 4, 4, 2, seed=2), _u(3, 4, 4, 2, seed=3)
    w = (_u(32, 5, seed=4) - 0.5)
    key = jax.random.PRNGKey(5)
    alpha = np.asarray(jax.random.uniform(key, (3, 1, 1, 1)))

    def jax_pen(w):
        return jax_gp(lambda x: jnp.tanh(x.reshape(3, -1) @ w).sum(-1),
                      jnp.asarray(real), jnp.asarray(fake), key)

    want, want_g = jax.value_and_grad(jax_pen)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = gradient_penalty(lambda x: torch.tanh(x.reshape(3, -1) @ wt).sum(-1),
                           torch.from_numpy(real), torch.from_numpy(fake),
                           alpha=torch.from_numpy(alpha))
    (got_g,) = torch.autograd.grad(got, wt)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert _rel(got_g, want_g) <= 1e-5
    # drawn from a generator: one α a sample, in [0, 1)
    gen = torch.Generator().manual_seed(0)
    again = gradient_penalty(lambda x: x.sum((1, 2, 3)), torch.zeros(4, 2, 2, 1),
                             torch.ones(4, 2, 2, 1), generator=gen)
    assert float(again) == pytest.approx(1.0, abs=1e-6)   # ‖∇‖ = 2


# -------------------------------------------------------------- networks

def _disc_pair(name):
    x = _u(B, 32, 32, 3, seed=6)
    if name == "vgg128":
        jm, tm, net = JaxD128(nf=8), DiscriminatorVGG128(nf=8, hr_size=32), \
            "DiscriminatorVGG128"
    else:
        jm, tm, net = JaxACD(), ACDVGGBN96(hr_size=32), "ACDVGGBN96"
    v = jax_variables(jm, jnp.zeros((1, 32, 32, 3)), train=True, seed=7)
    # statistics away from flax's 0 / 1 init, so that their use shows
    rng = np.random.default_rng(8)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    tm.load_state_dict(from_flax_gan(v, net), strict=True)
    return jm, v, tm, x, net


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["vgg128", "acd"])
def test_discriminator_matches_jax(name, train):
    jm, v, tm, x, net = _disc_pair(name)
    want, new = jm.apply(v, x, train=train, mutable=["batch_stats"])
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w in zip(_outputs(got), _outputs(want)):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= 2e-4
    stats = tm.state_dict()
    for k, w in from_flax_gan({"params": v["params"], **new}, net).items():
        if "running" in k:
            assert float((stats[k] - w).abs().max()) <= 1e-6, k
    if train:
        before = {k: t.clone() for k, t in tm.state_dict().items()}
        with torch.no_grad(), batch_stats_only(tm):
            again = tm(torch.from_numpy(x))
        assert all(torch.equal(before[k], t) for k, t in
                   tm.state_dict().items())
        for a, g in zip(_outputs(again), _outputs(got)):
            assert torch.equal(a, g)


@pytest.mark.parametrize("name", ["SFTNet", "SFTNetTorch"])
def test_sft_generators_match_jax(name):
    jm, tm = {"SFTNet": (JaxSFTNet(), SFTNet()),
              "SFTNetTorch": (JaxSFTNetTorch(), SFTNetTorch())}[name]
    img, seg = _u(B, SIDE, SIDE, 3, seed=9), _u(B, 4 * SIDE, 4 * SIDE, 8,
                                               seed=10)
    v = jax_variables(jm, img, seg, seed=11)
    sd = from_flax_gan(v, name)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    want = jm.apply(v, img, seg)
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(seg))
    assert got.shape == (B, 4 * SIDE, 4 * SIDE, 3)
    assert _rel(got, want) <= 2e-4


def test_define_d_sizes_linear1_from_the_hr_size():
    from endosr_torch.nn.networks import define_D

    opt = {"network_D": {"which_model_D": "discriminator_vgg_128", "nf": 8},
           "datasets": {"train": {"LR_size": 32}}, "scale": 4}
    d = define_D(opt, device="cpu")
    assert d.linear1.weight.shape == (100, 8 * 8 * 4 * 4)   # the reference's
    d = define_D(dict(opt, datasets={"train": {"LR_size": 8}}), device="cpu")
    assert d.linear1.weight.shape == (100, 8 * 8)


# ------------------------------------------------------------- SRGAN

GAN_TRAIN = {"gan_weight": 5e-3, "pixel_weight": 1e-2, "feature_weight": 0,
             "D_update_ratio": 2, "D_init_iters": 0, "lr_D": LR,
             "beta1_D": 0.9, "beta2_D": 0.99, "weight_decay_D": 1e-4}
SRGAN_NET = {"which_model_G": "MSRResNet", "nf": 16, "nb": 1}
G_KEYS = {"l_g_pix", "l_g_gan"}
D_KEYS = {"l_d_real", "l_d_fake", "D_real", "D_fake"}


def _srgan_opt(gan_type, vgg=None):
    t = dict(GAN_TRAIN, gan_type=gan_type, lr_G=LR)
    if vgg:
        t.update(feature_weight=1.0, feature_criterion="l1",
                 vgg_weights_path=vgg)
    opt = model_opt("srgan", dict(SRGAN_NET), t,
                    network_D={"which_model_D": "discriminator_vgg_128",
                               "nf": 8})
    opt["datasets"]["train"]["LR_size"] = GAN_SIDE
    return opt


def _gan_state(jm, g_net="MSRResNet", d_net="DiscriminatorVGG128"):
    """A JAX GAN model's state → (netG state_dict, netD state_dict)."""
    p = tree_np(jm.state.params)
    g = from_flax(p["netG"]) if g_net == "MSRResNet" else \
        from_flax_gan(p["netG"], g_net)
    return g, from_flax_gan({"params": p["netD"],
                             "batch_stats": p["netD_stats"]}, d_net)


def _load(tm, state):
    g, d = state
    tm.netG.load_state_dict(g, strict=True)
    tm.netD.load_state_dict(d, strict=True)


def _closure(fn):
    f = fn.__wrapped__
    return dict(zip(f.__code__.co_freevars,
                    (c.cell_contents for c in f.__closure__)))


def _named(net, what):
    return {k: (p.grad if what == "grad" else p).detach().clone()
            for k, p in net.named_parameters()}


def _stats(net):
    return {k: v.clone() for k, v in net.state_dict().items()
            if "running" in k}


def _jax_gan_grad_fn(jm, seg=False):
    """The jitted gradients of a JAX GAN model's G + D step (the train
    step's own loss functions, built from the model's networks as they
    are): (params, batch) → (G's, D's; D's on the fake of G before its
    update)."""
    cells = _closure(jm._build_train_step(True, False) if seg
                     else jm._build_train_step(True))

    def grads(p, jb):
        g_tree = p["netG"] if seg else {"netG": p["netG"]}
        g, (_, fake) = jax.grad(cells["g_loss_fn"], has_aux=True)(
            g_tree, p["netD"], p["netD_stats"], jb)
        d, _ = jax.grad(cells["d_loss_fn"], has_aux=True)(
            p["netD"], p["netD_stats"], fake, jb)
        return (g if seg else g["netG"]), d

    return jax.jit(grads)


def _as_port(grads, d_net="DiscriminatorVGG128", g_net="MSRResNet",
             dtype=np.float32):
    g, d = tree_np(grads)
    g_sd = from_flax(g, dtype=dtype) if g_net == "MSRResNet" else \
        from_flax_gan(g, g_net, dtype)
    return g_sd, from_flax_gan(d, d_net, dtype)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


# the JAX modules that name fp32 in the GAN steps: the convs' and the
# resize's operand casts, BatchNorm's ``dtype``, the networks' outputs,
# the cross-entropy's mask
_FP32_PINNED = (jax_layers, jax_resize, jax_discriminator, jax_srresnet,
                jax_sft_arch, jax_sftgan_model)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jax_f64_grads(jm, params, batch, seg=False, nets=(
        "DiscriminatorVGG128", "MSRResNet")):
    """JAX's own float64 gradients of the G + D step from each state of
    ``params`` (a list; each gives ``G.`` / ``D.`` keys, float64 tensors):
    the JAX model's networks (and its VGG) cloned with ``dtype=float64``,
    the fp32 those modules name read as float64, under
    ``jax.enable_x64``. The yardstick of both packages' fp32 gradients."""
    saved = [m.jnp for m in _FP32_PINNED]
    out = []
    try:
        with jax.enable_x64(True):
            for m in _FP32_PINNED:
                m.jnp = _Float64Numpy()
            m64 = copy.copy(jm)
            m64.netG = jm.netG.clone(dtype=jnp.float64)
            m64.netD = jm.netD.clone(dtype=jnp.float64)
            if jm.cri_fea is not None:
                m64.cri_fea = copy.copy(jm.cri_fea)
                m64.cri_fea.model = jm.cri_fea.model.clone(dtype=jnp.float64)
                m64.cri_fea.variables = _f64(jm.cri_fea.variables)
            jb = {k: jnp.asarray(v if k == "category" else
                                 np.asarray(v, np.float64))
                  for k, v in batch.items()}
            fn = _jax_gan_grad_fn(m64, seg)
            for p in params:
                g, d = _as_port(fn(_f64(p), jb), *nets, dtype=np.float64)
                out.append({**{f"G.{k}": v for k, v in g.items()},
                            **{f"D.{k}": v for k, v in d.items()}})
    finally:
        for m, j in zip(_FP32_PINNED, saved):
            m.jnp = j
    return out


def _srgan_run(gan_type, vgg=None):
    opt = _srgan_opt(gan_type, vgg)
    batch = {"LQ": _u(B, GAN_SIDE, GAN_SIDE, 3, seed=12),
             "GT": _u(B, 4 * GAN_SIDE, 4 * GAN_SIDE, 3, seed=13)}
    jm = jax_model(jax_create, copy.deepcopy(opt))
    params = [tree_np(jm.state.params)]
    out = {"jax_states": [_gan_state(jm)], "jax_logs": []}
    jm.feed_data(batch)
    for n in range(1, STEPS + 1):
        jm.optimize_parameters(n)
        out["jax_logs"].append(dict(jm.log_dict))
        out["jax_states"].append(_gan_state(jm))
        params.append(tree_np(jm.state.params))
    # D's gradient of step 1 (from the start) and G's and D's of step 2
    # (from JAX's state after step 1); step 2's also in float64
    fn = _jax_gan_grad_fn(jm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out["jax_d1"] = _as_port(fn(params[0], jb))[1]
    out["jax_grads"] = _as_port(fn(params[1], jb))
    out["jax64"] = _jax_f64_grads(jm, params[1:2], batch)[0]
    # the port from the same start
    tm = create_model(copy.deepcopy(opt), device="cpu")
    _load(tm, out["jax_states"][0])
    tm.feed_data(batch)
    out["logs"], out["states"] = [], []
    for n in range(1, STEPS + 1):
        out["logs"].append(dict(tm.optimize_parameters(n)))
        out["states"].append((_named(tm.netG, "p"), _named(tm.netD, "p")))
        if n == 1:
            out["grads_d1"] = _named(tm.netD, "grad")
        if n == 2:
            out["grads_g2"] = _named(tm.netG, "grad")
    # step 2 alone, from JAX's state after step 1; again with oneDNN off
    out["step2"] = _step_from(opt, batch, out["jax_states"][1])
    with torch.backends.mkldnn.flags(enabled=False):
        again = _step_from(opt, batch, out["jax_states"][1])
    out["noise"] = {k: float((again["grads"][k] - g).abs().max())
                    for k, g in out["step2"]["grads"].items()}
    out["jm"], out["model"], out["batch"], out["opt"] = jm, tm, batch, opt
    return out


def _step_from(opt, batch, state, step=2):
    tm = create_model(copy.deepcopy(opt), device="cpu")
    _load(tm, state)
    tm.feed_data(batch)
    logs = dict(tm.optimize_parameters(step))
    grads = {**{f"G.{k}": v for k, v in _named(tm.netG, "grad").items()},
             **{f"D.{k}": v for k, v in _named(tm.netD, "grad").items()}}
    return {"logs": logs, "grads": grads, "stats": _stats(tm.netD)}


@pytest.fixture(scope="module")
def srgan():
    cache = {}

    def get(gan_type):
        if gan_type not in cache:
            cache[gan_type] = _srgan_run(gan_type)
        return cache[gan_type]

    return get


# ``ragan`` (with the VGG feature loss): ``tests/test_torch_gan_ragan.py``
GAN_TYPES = ["gan", "lsgan", "wgan-gp"]


# the logs computed from D's logits (its outputs' bar, 2e-4: at HR 32 the
# last BatchNorms see two values a channel, and the logits agree to ~1e-5
# of their largest)
LOGIT_LOGS = {k: 2e-4 for k in ("D_real", "D_fake", "l_d_real", "l_d_fake",
                                "l_g_gan", "l_g_cls", "l_d_cls_real",
                                "l_d_cls_fake")}


def _logs_close(got, want, tol, label):
    assert sorted(got) == sorted(want), label
    for k, v in want.items():
        t = LOGIT_LOGS.get(k, tol)
        assert abs(got[k] - v) <= t * max(abs(v), 1e-12), \
            f"{label} {k}: {got[k]} vs {v}"


def check_srgan_logs(r, gan_type):
    g_keys = G_KEYS | ({"l_g_fea"} if gan_type == "ragan" else set())
    for n, (got, want) in enumerate(zip(r["logs"], r["jax_logs"]), start=1):
        keys = (g_keys | D_KEYS) if n % 2 == 0 else D_KEYS
        assert set(got) == set(want) == keys, n
    _logs_close(r["logs"][0], r["jax_logs"][0], 1e-5, "step 1")
    _logs_close(r["step2"]["logs"], r["jax_logs"][1], 1e-5, "step 2")


def _grad_fails(got, want64, noise=None):
    """The tensors of ``got`` (the port's fp32 gradients) farther from
    JAX's float64 ones than 2e-4 of the tensor's largest + 4× the port's
    own difference with oneDNN's convolutions off (``noise``)."""
    fails = []
    for k, w in want64.items():
        bar = 2e-4 * float(w.abs().max()) + 4 * (noise or {}).get(k, 0.0)
        err = float((got[k].double() - w).abs().max())
        if not err <= bar:
            fails.append((k, err, bar))
    return fails


def record_gradient_readings(record, got, jax32, want64):
    """Into the test report (``record_property``): the port's and JAX's
    fp32 gradients' largest distance from JAX's float64 ones, each as a
    share of the tensor's largest (tensors whose float64 gradient is 0,
    such as ``ragan``'s ``linear2.bias``, left out)."""
    for name, grads in (("port_fp32", got), ("jax_fp32", jax32)):
        rel = {k: float((grads[k].double() - w).abs().max())
               / float(w.abs().max()) for k, w in want64.items()
               if float(w.abs().max()) > 0}
        worst = max(rel, key=rel.get)
        record(f"{name}_vs_jax_float64", f"{rel[worst]:.3g} ({worst})")


def check_srgan_gradients(r, record):
    got = r["step2"]["grads"]
    assert sorted(got) == sorted(r["jax64"])
    g, d = r["jax_grads"]
    record_gradient_readings(record, got, {
        **{f"G.{k}": v for k, v in g.items()},
        **{f"D.{k}": v for k, v in d.items()}}, r["jax64"])
    fails = _grad_fails(got, r["jax64"], r["noise"])
    assert not fails, fails


def check_srgan_d_statistics(r):
    """Two updates of D's running statistics a G + D step (GT, then the
    fake), none from G's forward: within 1e-6 of JAX's; three would move
    them by the momentum's share of a third batch."""
    want = r["jax_states"][2][1]
    got = r["step2"]["stats"]
    before = r["jax_states"][1][1]
    for k, v in got.items():
        assert float((v - want[k]).abs().max()) <= 1e-6, k
    moved = max(float((want[k] - before[k]).abs().max()) for k in got)
    assert moved > 1e-3


# after all updates (4 of D, 2 of G), the strong components within 25 %
# of the distance JAX moved them, in norm (measured ≤ 18 %: ragan's D
# ``bn0_1.bias``; JAX's fp32 gradients of D's BatchNorm layers are
# percents off its float64 ones at every step, and G's follow D's)
FRAC_ALL = 0.25


def _weights(sd):
    return {k: v for k, v in sd.items()
            if "running" not in k and "num_batches" not in k}


def check_srgan_parameters(r, gan_type):
    g0, d0 = r["jax_states"][0]
    d0 = _weights(d0)
    # D updates every step, its first gradient is step 1's; G at steps 2
    # and 4, its first gradient is step 2's
    for n in (1, STEPS):
        check_updates(r["states"][n - 1][1], _weights(r["jax_states"][n][1]),
                      d0, LR, n, r["grads_d1"], r["jax_d1"], f"{gan_type} D",
                      frac3=FRAC_ALL, wd=1e-4)
    for n, step in ((1, 2), (2, STEPS)):
        check_updates(r["states"][step - 1][0], r["jax_states"][step][0], g0,
                      LR, n, r["grads_g2"], r["jax_grads"][0],
                      f"{gan_type} G", frac3=FRAC_ALL)
    # a D-only step leaves G as it was
    assert all(torch.equal(r["states"][0][0][k], g0[k]) for k in g0)


@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_srgan_logs_match_jax(srgan, gan_type):
    check_srgan_logs(srgan(gan_type), gan_type)


@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_srgan_gradients_match_jax(srgan, gan_type, record_property):
    check_srgan_gradients(srgan(gan_type), record_property)


@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_srgan_d_statistics_after_a_g_and_d_step(srgan, gan_type):
    check_srgan_d_statistics(srgan(gan_type))


@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_srgan_parameters_after_updates_match_jax(srgan, gan_type):
    check_srgan_parameters(srgan(gan_type), gan_type)


def _paths(tmp_path):
    return {"models": str(tmp_path / "models"),
            "training_state": str(tmp_path / "state")}


def _reference_names(path):
    """The reference checkpoint's key of a flax path, names kept."""
    *mods, leaf = path
    return ".".join(mods + [{"kernel": "weight", "scale": "weight"}.get(
        leaf, leaf)])


def test_jax_load_network_reads_the_ports_d_checkpoint_c17(tmp_path, srgan):
    """JAX's ``load_network`` reads the port's ``{iter}_D.pth`` to the
    same weights with the reference's names as its key function. With its
    default one it cannot (C17): ``conv0_0`` is looked up as ``conv0.0``,
    ``bn0_1`` as ``bn0.1``;
    nor an SFTNet checkpoint (``CondNet.0`` as ``CondNet.CondNet.0``)."""
    r = srgan("gan")
    tm, jm = r["model"], r["jm"]
    tm.opt["path"] = _paths(tmp_path)
    tm.save(7)
    path = str(tmp_path / "models/7_D.pth")
    template = jm.state.params["netD"]
    got = jm.load_network(path, template, True, key_fn=_reference_names)
    want = _weights(tm.netD.state_dict())
    ported = from_flax_gan(tree_np(got), "DiscriminatorVGG128")
    assert sorted(ported) == sorted(want)
    for k, v in want.items():
        assert torch.equal(ported[k], v), k
    with pytest.raises(KeyError, match=r"bn0\.1\.bias"):
        jm.load_network(path, template, True)
    sft = tmp_path / "G_sft.pth"
    torch.save(SFTNet().state_dict(), sft)
    sft_template = jax.eval_shape(lambda: JaxSFTNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
        jnp.zeros((1, 32, 32, 8))))["params"]
    with pytest.raises(KeyError, match="CondNet.CondNet.0"):
        jm.load_network(str(sft), jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), sft_template), True)


def test_srgan_g_adam_reads_beta1_not_beta1_g_c18():
    """C18: G's Adam takes ``train.beta1`` / ``beta2`` (``make_adam``), as
    JAX's ``SRGANModel`` (``endosr/models/srgan_model.py:78``), not the
    reference's ``beta1_G`` / ``beta2_G``; D's takes ``beta1_D`` /
    ``beta2_D``."""
    opt = _srgan_opt("gan")
    opt["train"].update(beta1_G=0.5, beta2_G=0.9, beta1=0.8, beta2=0.95,
                        beta1_D=0.7, beta2_D=0.97)
    tm = create_model(copy.deepcopy(opt), device="cpu")
    assert tm.optimizer_G.param_groups[0]["betas"] == (0.8, 0.95)
    assert tm.optimizer_D.param_groups[0]["betas"] == (0.7, 0.97)
