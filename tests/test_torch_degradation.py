"""The port's degradation toolkit (``endosr_torch/ops/degradation.py``)
against the JAX package's, fp32 on the CPU, on JAX's own random draws
(passed in through the ``draws`` / ``noise`` arguments): the cases of
``tests/test_degradation.py`` again, each output ≤ 1e-5 of max |ref|;
``pca_matrix`` bit-equal (the same numpy SVD); the port's own draws come
from a ``torch.Generator`` and repeat with its seed."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosr.ops import degradation as jd
from endosr_torch.ops import degradation as td
from tests.torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(11)
TOL = 1e-5


def _close(got, want, tol=TOL):
    w = np.asarray(want)
    g = got.detach().numpy()
    assert g.shape == w.shape
    assert float(np.abs(g - w).max()) <= tol * max(float(np.abs(w).max()),
                                                   1e-30)


def _kernel_draws(key, b, sig_min=0.2, sig_max=4.0):
    """``random_batch_kernel``'s draws from ``key``, as JAX draws them."""
    k_iso, k_theta, k_x, k_y, k_choice = jax.random.split(key, 5)
    u = jax.random.uniform
    return {"sig": u(k_iso, (b,), minval=sig_min, maxval=sig_max),
            "theta": u(k_theta, (b,), minval=-math.pi, maxval=math.pi),
            "x": u(k_x, (b,), minval=sig_min, maxval=sig_max),
            "y": u(k_y, (b,)), "choice": u(k_choice, (b, 1, 1))[:, 0, 0]}


def _t(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("rate_iso", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("l", [21, 10])
def test_random_batch_kernel_matches_jax(l, rate_iso):
    key = jax.random.PRNGKey(0)
    want = jd.random_batch_kernel(key, 8, l=l, rate_iso=rate_iso)
    got = td.random_batch_kernel(8, l, rate_iso=rate_iso,
                                 draws=_t(_kernel_draws(key, 8)))
    _close(got, want)
    np.testing.assert_allclose(got.sum((1, 2)).numpy(), 1.0, rtol=1e-5)


def test_kernels_normalized_and_seeded():
    gen = torch.Generator().manual_seed(3)
    k = td.random_batch_kernel(8, 21, rate_iso=0.5, generator=gen)
    again = td.random_batch_kernel(8, 21, rate_iso=0.5,
                                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(k, again) and bool((k >= 0).all())
    np.testing.assert_allclose(k.sum((1, 2)).numpy(), 1.0, rtol=1e-5)
    ks = td.stable_batch_kernel(4, 21, 2.6)
    _close(ks, jd.stable_batch_kernel(4, 21, 2.6))
    assert torch.equal(ks[0], ks[3])


@pytest.mark.parametrize("l,sig", [(13, 1.7), (21, 2.6), (8, 0.9)])
def test_iso_kernel_matches_jax_and_the_reference_formula(l, sig):
    got = td.isotropic_gaussian_kernel(l, sig)
    _close(got, jd.isotropic_gaussian_kernel(l, sig))
    ax = np.arange(-l // 2 + 1.0, l // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    want = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sig ** 2))
    np.testing.assert_allclose(got.numpy(), want / want.sum(), rtol=1e-5)


def test_aniso_kernel_and_cal_sigma_match_jax():
    sx, sy, th = (RNG.uniform(0.2, 4.0, 5).astype(np.float32),
                  RNG.uniform(0.2, 4.0, 5).astype(np.float32),
                  RNG.uniform(-3, 3, 5).astype(np.float32))
    want_s = jd._cal_sigma(jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(th))
    got_s = td._cal_sigma(torch.from_numpy(sx), torch.from_numpy(sy),
                          torch.from_numpy(th))
    _close(got_s, want_s)
    _close(td.anisotropic_gaussian_kernel(15, got_s),
           jd.anisotropic_gaussian_kernel(15, want_s))


@pytest.mark.parametrize("l", [9, 10])
def test_batch_blur_matches_jax(l):
    b, c, h, w = 2, 3, 16, 12
    imgs = RNG.random((b, h, w, c)).astype(np.float32)
    kernels = np.asarray(jd.random_batch_kernel(jax.random.PRNGKey(1), b, l=l,
                                                rate_iso=0.5))
    want = jd.batch_blur(jnp.asarray(imgs), jnp.asarray(kernels))
    _close(td.batch_blur(torch.from_numpy(imgs), torch.from_numpy(kernels)),
           want)


def test_pca_matrix_bit_equal_and_encode_matches_jax():
    kernels = np.asarray(jd.random_batch_kernel(jax.random.PRNGKey(2), 64,
                                                l=11, rate_iso=0.7))
    w = td.pca_matrix(kernels, k=10)
    assert np.array_equal(w, jd.pca_matrix(kernels, k=10))
    np.testing.assert_allclose(w.T @ w, np.eye(10), atol=1e-4)
    _close(td.pca_encode(torch.from_numpy(kernels), torch.from_numpy(w)),
           jd.pca_encode(jnp.asarray(kernels), jnp.asarray(w)))


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_bicubic_downsample_matches_jax(scale):
    imgs = RNG.random((2, 24, 36, 3)).astype(np.float32)
    _close(td.bicubic_downsample(torch.from_numpy(imgs), scale),
           jd.bicubic_downsample(jnp.asarray(imgs), scale))
    flat = td.bicubic_downsample(torch.full((1, 16, 16, 3), 0.25), 4)
    np.testing.assert_allclose(flat.numpy(), 0.25, atol=1e-6)


def test_noise_matches_jax():
    key = jax.random.PRNGKey(6)
    k1, k2 = jax.random.split(key)
    want = jd.random_batch_noise(key, 6, 0.08, rate_cln=0.5)
    draws = {"level": jax.random.uniform(k1, (6, 1)),
             "mask": jax.random.uniform(k2, (6, 1))}
    level = td.random_batch_noise(6, 0.08, 0.5, draws=_t(draws))
    _close(level, want)
    imgs = RNG.random((6, 8, 8, 3)).astype(np.float32)
    noise = jax.random.normal(key, imgs.shape)
    want = jd.gaussian_noising(key, jnp.asarray(imgs), jnp.asarray(want))
    got = td.gaussian_noising(torch.from_numpy(imgs), level,
                              noise=torch.from_numpy(np.array(noise)))
    _close(got, want)


@pytest.mark.parametrize("random,noise,scale", [(True, True, 4),
                                                (False, False, 2),
                                                (True, False, 3)])
def test_srmd_preprocessing_matches_jax(random, noise, scale):
    kernels = np.asarray(jd.random_batch_kernel(jax.random.PRNGKey(3), 32,
                                                l=21))
    pca = jd.pca_matrix(kernels, k=10)
    hr = RNG.random((2, 24, 24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jd.SRMDPreprocessing(scale, pca, random=random, noise=noise)(
        key, jnp.asarray(hr), True)
    k_kernel, k_level, k_noise = jax.random.split(key, 3)
    draws = {}
    if random:
        draws["kernel"] = _t(_kernel_draws(k_kernel, 2))
    if noise:
        k1, k2 = jax.random.split(k_level)
        draws["level"] = _t({"level": jax.random.uniform(k1, (2, 1)),
                             "mask": jax.random.uniform(k2, (2, 1))})
        draws["noise"] = torch.from_numpy(np.array(jax.random.normal(
            k_noise, (2, 24 // scale, 24 // scale, 3))))
    pre = td.SRMDPreprocessing(scale, pca, random=random, noise=noise)
    got = pre(torch.from_numpy(hr), True, draws=draws)
    assert got[1].shape == (2, 11 if noise else 10)
    for g, w in zip(got, want):
        _close(g, w)
    # the port's own draws: seeded, in range
    lr, code = pre(torch.from_numpy(hr),
                   generator=torch.Generator().manual_seed(5))
    lr2, _ = pre(torch.from_numpy(hr),
                 generator=torch.Generator().manual_seed(5))
    assert torch.equal(lr, lr2) and float(lr.min()) >= 0 and float(
        lr.max()) <= 1


@pytest.mark.parametrize("noise", [False, True])
def test_iso_gaussian_matches_jax(noise):
    pca = RNG.random((441, 10)).astype(np.float32)
    hr = RNG.random((3, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jd.IsoGaussian(4, pca, noise=noise, noise_high=0.05)(
        key, jnp.asarray(hr))
    k_sig, k_noise = jax.random.split(key)
    draws = {"sig": torch.from_numpy(np.array(jax.random.uniform(
        k_sig, (3,), minval=1.8, maxval=3.2))),
        "noise": torch.from_numpy(np.array(jax.random.normal(
            k_noise, (3, 4, 4, 3))))}
    got = td.IsoGaussian(4, pca, noise=noise, noise_high=0.05)(
        torch.from_numpy(hr), draws=draws)
    for g, w in zip(got, want):
        _close(g, w)
