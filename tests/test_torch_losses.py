"""The port's losses, SSIM and LR schedules against the JAX package's.

Same numpy inputs through both, fp32 on the CPU. Loss and SSIM values to
≤ 1e-6 relative, except the Charbonnier sums (one fp32 sum of every
pixel's term, 2 304 terms here, whose summation orders differ: ≤ 4e-6);
the gradients a training step takes of them to ≤ 5e-6 of the gradient's
largest magnitude (measured: up to 2.5e-6, rounding of the divisions and
sums the backward passes through). The per-bin losses on both mask paths (block sums when the mask's size divides
the image's, resized masks otherwise), the mask loss at a fixed bin.
Schedules at every step of short periods, restarts and milestones
included, with and without warmup, to ≤ 1e-6 relative; at the flagship's
periods (20 000 updates) also within 1e-7 of the base LR, since XLA's fp32
cosine is not correctly rounded and 1 + cos cancels near a period's end.
``clear_state_at`` is held against the optax wrapper on a few updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from endosr.losses import basic as jb
from endosr.losses import mask as jm
from endosr.losses import ssim as js
from endosr.metrics.psnr_ssim import ssim_jax
from endosr.models import lr_schedule as jl
from endosr_torch.losses import basic as tb
from endosr_torch.losses import mask as tm
from endosr_torch.losses import ssim as ts
from endosr_torch.metrics.psnr_ssim import ssim
from endosr_torch.models import lr_schedule as tl

REL = 1e-6
REL_SUM = 4e-6      # a Charbonnier sum: one fp32 sum of every pixel's term
REL_GRAD = 5e-6


def _close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= rel * scale, f"max |Δ| {err:.3g} > {rel:g} · {scale:.3g}"


def _images(seed=0, shape=(2, 16, 24, 3)):
    rng = np.random.default_rng(seed)
    sr = rng.random(shape, dtype=np.float32) * 1.6 - 0.3   # |d| > 1 too
    hr = rng.random(shape, dtype=np.float32)
    return sr, hr


def _masks(shape, k=4, seed=1):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, k, shape)
    return np.stack([(bins == i) for i in range(k)], -1).astype(np.float32)


def _grad(fn, *arrays):
    """(value, gradient w.r.t. the first argument) of a scalar torch loss."""
    x = torch.from_numpy(arrays[0]).requires_grad_(True)
    v = fn(x, *map(torch.from_numpy, arrays[1:]))
    v.backward()
    return v, x.grad


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "charbonnier_loss"])
def test_pixel_losses_match_jax(name):
    sr, hr = _images()
    v, g = _grad(getattr(tb, name), sr, hr)
    jv, jg = jax.value_and_grad(getattr(jb, name))(sr, hr)
    _close(v, jv, REL_SUM if name == "charbonnier_loss" else REL)
    _close(g, jg, REL_GRAD)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_smooth_l1_matches_jax(reduction):
    sr, hr = _images()
    got = tb.smooth_l1_loss(torch.from_numpy(sr), torch.from_numpy(hr),
                            reduction=reduction)
    _close(got, jb.smooth_l1_loss(sr, hr, reduction=reduction))


def test_pixel_loss_names():
    assert tb.pixel_loss("l1") is tb.l1_loss
    assert tb.pixel_loss("l2") is tb.l2_loss
    assert tb.pixel_loss("cb") is tb.charbonnier_loss
    with pytest.raises(NotImplementedError, match="xx"):
        tb.pixel_loss("xx")


# block: a 4×6 mask under a 16×24 image; resize: a 5×7 mask does not divide
MASK_PATHS = {"block": (4, 6), "resize": (5, 7)}


@pytest.mark.parametrize("criterion", ["smoothl1", "l1", "l2", "cb"])
@pytest.mark.parametrize("path", list(MASK_PATHS))
def test_per_bin_masked_loss_matches_jax(criterion, path):
    sr, hr = _images()
    m = _masks((2, *MASK_PATHS[path]))
    v, g = _grad(lambda x, h, mm: tm.per_bin_masked_loss(
        x, h, mm, criterion).sum(), sr, hr, m)
    jv, jg = jax.value_and_grad(lambda x: jm.per_bin_masked_loss(
        x, hr, m, criterion).sum())(sr)
    _close(tm.per_bin_masked_loss(*map(torch.from_numpy, (sr, hr, m)),
                                  criterion),
           jm.per_bin_masked_loss(sr, hr, m, criterion),
           REL_SUM if criterion == "cb" else REL)
    _close(v, jv, REL_SUM if criterion == "cb" else REL)
    _close(g, jg, REL_GRAD)


@pytest.mark.parametrize("criterion", ["smoothl1", "l1", "l2", "cb"])
@pytest.mark.parametrize("path", list(MASK_PATHS))
def test_mask_loss_matches_jax_at_a_fixed_bin(criterion, path):
    sr, hr = _images()
    m = _masks((2, *MASK_PATHS[path]))
    for k in (0, 3):
        v, g = _grad(lambda x, h, mm: tm.mask_loss(x, h, mm, k, criterion,
                                                   2.5), sr, hr, m)
        jv, jg = jax.value_and_grad(lambda x: jm.mask_loss(
            x, hr, m, jnp.int32(k), criterion, 2.5))(sr)
        _close(v, jv, REL_SUM if criterion == "cb" else REL)
        _close(g, jg, REL_GRAD)


@pytest.mark.parametrize("criterion", ["smoothl1", "l1"])
def test_dynamic_weight_mask_loss_matches_jax(criterion):
    sr, hr = _images()
    m = _masks((2, 4, 6))
    w0 = np.asarray([0.3, -0.2, 1.1, 0.0], np.float32)
    x = torch.from_numpy(sr).requires_grad_(True)
    w = torch.from_numpy(w0).requires_grad_(True)
    got = tm.dynamic_weight_mask_loss(x, torch.from_numpy(hr),
                                      torch.from_numpy(m), w, criterion, 10.0)
    want = jm.dynamic_weight_mask_loss(sr, hr, m, w0, criterion, 10.0)
    for a, b in zip(got, want):
        _close(a, b)
    got[2].backward()
    jg = jax.grad(lambda s, ww: jm.dynamic_weight_mask_loss(
        s, hr, m, ww, criterion, 10.0)[2], argnums=(0, 1))(sr, w0)
    _close(x.grad, jg[0], REL_GRAD)
    _close(w.grad, jg[1], REL_GRAD)


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 13, 11, 3)])
def test_ssim_matches_jax(shape):
    sr, hr = _images(shape=shape)
    sr = np.clip(sr, 0, 1)
    _close(ssim(torch.from_numpy(sr), torch.from_numpy(hr)), ssim_jax(sr, hr))
    v, g = _grad(ts.ssim_value, sr, hr)
    jv, jg = jax.value_and_grad(js.ssim_value)(sr, hr)
    _close(v, jv)
    _close(g, jg, REL_GRAD)


@pytest.mark.parametrize("one_minus", [False, True])
def test_ssim_loss_keeps_the_reference_sign(one_minus):
    sr, hr = _images()
    got = ts.ssim_loss(torch.from_numpy(sr), torch.from_numpy(hr), 0.7,
                       one_minus=one_minus)
    _close(got, js.ssim_loss(sr, hr, 0.7, one_minus=one_minus))


_COS = dict(lr_G=1e-3, lr_scheme="CosineAnnealingLR_Restart",
            T_period=[7, 5, 9, 6], restarts=[7, 12, 21],
            restart_weights=[1, 0.5, 0.25], eta_min=1e-7)
SCHEDULES = {
    "cosine_restart": _COS,
    "multistep_restart": dict(lr_G=2e-4, lr_scheme="MultiStepLR_Restart",
                              lr_steps=[3, 6, 9, 14, 20], lr_gamma=0.1,
                              restarts=[10, 17], restart_weights=[0.5, 0.3]),
    "multistep": dict(lr_G=2e-4, lr_scheme="MultiStepLR",
                      lr_steps=[3, 6, 9, 14, 20], lr_gamma=0.5),
}


@pytest.mark.parametrize("warmup", [-1, 4])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name, warmup):
    opt = dict(SCHEDULES[name], warmup_iter=warmup)
    want = jax.jit(jax.vmap(jl.build_schedule(opt)))(np.arange(30))
    got = [tl.build_schedule(opt)(s) for s in range(30)]
    for s in range(30):
        _close(np.float32(got[s]), want[s])


def test_step_lr_matches_jax():
    want = jax.vmap(jl.step_lr(1e-3, 4, 0.3))(np.arange(40))
    for s in range(40):
        _close(np.float32(tl.step_lr(1e-3, 4, 0.3)(s)), want[s])


def test_flagship_schedule_matches_jax_near_restarts():
    opt = dict(_COS, T_period=[20000] * 4, restarts=[20000, 40000, 60000],
               restart_weights=[1, 1, 1])
    steps = np.concatenate([np.arange(r - 40, r + 40)
                            for r in (40, 20000, 40000, 60000, 80000)])
    want = np.asarray(jax.jit(jax.vmap(jl.build_schedule(opt)))(steps))
    got = np.asarray([tl.build_schedule(opt)(int(s)) for s in steps])
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-7 * 1e-3)


def test_clear_state_at_matches_optax():
    """Adam wrapped to clear its state at update 2 (MultiStepLR_Restart with
    clear_state), five updates of one parameter vector, against optax."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = [rng.standard_normal(6).astype(np.float32) for _ in range(5)]
    tx = optax.chain(jl.clear_state_at([2])(optax.scale_by_adam(0.9, 0.99)),
                     optax.scale_by_learning_rate(1e-2))
    p, st = jnp.asarray(p0), None
    st = tx.init(p)
    want = []
    for g in grads:
        u, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, u)
        want.append(np.asarray(p))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([tp], lr=1e-2, betas=(0.9, 0.99), eps=1e-8)
    clear = tl.clear_state_at([2])
    for n, g in enumerate(grads):
        tp.grad = torch.from_numpy(g)
        clear(opt, n)
        opt.step()
        _close(tp, want[n], 1e-6)
