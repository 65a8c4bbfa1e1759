"""SRMD / IKC degradation toolkit (counterpart of
``endosr/ops/degradation.py``): isotropic and anisotropic Gaussian blur
kernels, PCA kernel codes, the batched blur, bicubic downsampling and
Gaussian noise, the pipeline that makes degraded LR inputs and kernel
codes for the Predictor / Corrector (IKC) models.

Everything runs on the device of its input, batched, in fp32: the blur is
one grouped conv over B·C channels (reflect padding), the downsampling
two matmuls with the MATLAB-conformant ``ops/resize.py::resize_matrix``
(TF32 off inside). Randomness comes from an explicit ``torch.Generator``;
each random function takes its draws as an argument too (``draws`` /
``noise``), so that a caller can pass in another source's — JAX's, in the
tests — and the function only builds from them.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from endosr_torch.ops.resize import resize_matrix
from endosr_torch.utils.device import device_constant

__all__ = ["isotropic_gaussian_kernel", "anisotropic_gaussian_kernel",
           "random_kernel_draws", "random_batch_kernel", "stable_batch_kernel",
           "pca_matrix", "pca_encode", "batch_blur", "bicubic_downsample",
           "noise_level_draws", "random_batch_noise", "gaussian_noising",
           "SRMDPreprocessing", "IsoGaussian"]

F32 = torch.float32


@contextlib.contextmanager
def _fp32_matmul(device):
    """Matmuls on ``device`` in true fp32 inside the block (no TF32),
    whatever the process-wide flag says; restored on leaving."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _mesh_np(l: int):
    ax = np.arange(-l // 2 + 1.0, l // 2 + 1.0)
    return np.stack(np.meshgrid(ax, ax)).astype(np.float32)


def _mesh(l: int, device):
    xx, yy = device_constant(_mesh_np, (l,), F32, device)
    return xx, yy


def _uniform(shape, lo, hi, generator, device):
    u = torch.rand(shape, generator=generator, device=device, dtype=F32)
    return lo + (hi - lo) * u


def isotropic_gaussian_kernel(l: int, sigma) -> torch.Tensor:
    """``sigma`` [...] → [..., l, l] kernels summing to 1."""
    sigma = torch.as_tensor(sigma, dtype=F32)
    xx, yy = _mesh(l, sigma.device)
    s = sigma[..., None, None]
    k = torch.exp(-(xx ** 2 + yy ** 2) / (2.0 * s ** 2))
    return k / k.sum(dim=(-2, -1), keepdim=True)


def anisotropic_gaussian_kernel(l: int, sigma_matrix) -> torch.Tensor:
    """A covariance ``sigma_matrix`` [..., 2, 2] → [..., l, l] kernels."""
    xx, yy = _mesh(l, sigma_matrix.device)
    xy = torch.stack([xx, yy], -1)
    inv = torch.linalg.inv(sigma_matrix)
    q = torch.einsum("hwi,...ij,hwj->...hw", xy, inv, xy)
    k = torch.exp(-0.5 * q)
    return k / k.sum(dim=(-2, -1), keepdim=True)


def _cal_sigma(sig_x, sig_y, theta):
    """U·diag(σx², σy²)·Uᵀ, U the rotation by ``theta``."""
    z = torch.zeros_like(sig_x)
    d = torch.stack([torch.stack([sig_x ** 2, z], -1),
                     torch.stack([z, sig_y ** 2], -1)], -2)
    c, s = torch.cos(theta), torch.sin(theta)
    u = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    return u @ d @ u.transpose(-1, -2)


def random_kernel_draws(batch: int, sig_min: float = 0.2, sig_max: float = 4.0,
                        generator=None, device=None) -> dict:
    """The draws of :func:`random_batch_kernel`, each [batch]: ``sig`` (the
    isotropic σ), ``theta``, ``x`` (σx), ``y`` (U[0, 1), scaled into σy)
    and ``choice`` (U[0, 1), below ``rate_iso`` picks the isotropic)."""
    return {"sig": _uniform(batch, sig_min, sig_max, generator, device),
            "theta": _uniform(batch, -math.pi, math.pi, generator, device),
            "x": _uniform(batch, sig_min, sig_max, generator, device),
            "y": _uniform(batch, 0.0, 1.0, generator, device),
            "choice": _uniform(batch, 0.0, 1.0, generator, device)}


def random_batch_kernel(batch: int, l: int = 21, sig_min: float = 0.2,
                        sig_max: float = 4.0, rate_iso: float = 1.0,
                        scaling: float = 3.0, generator=None, device=None,
                        draws=None) -> torch.Tensor:
    """[batch, l, l] Gaussian kernels, isotropic with probability
    ``rate_iso``, else anisotropic with σy = clip(y·scaling·σx)."""
    d = draws or random_kernel_draws(batch, sig_min, sig_max, generator,
                                     device)
    iso = isotropic_gaussian_kernel(l, d["sig"])
    y = torch.clamp(d["y"] * scaling * d["x"], sig_min, sig_max)
    aniso = anisotropic_gaussian_kernel(l, _cal_sigma(d["x"], y, d["theta"]))
    return torch.where((d["choice"] < rate_iso)[:, None, None], iso, aniso)


def stable_batch_kernel(batch: int, l: int = 21, sig: float = 2.6,
                        device=None) -> torch.Tensor:
    k = isotropic_gaussian_kernel(l, torch.tensor(sig, device=device))
    return k.expand(batch, l, l)


def pca_matrix(kernels: np.ndarray, k: int = 10) -> np.ndarray:
    """[N, l, l] kernels → their [l², k] PCA basis (float64 SVD of the
    centred kernels, as the JAX package computes it)."""
    x = np.asarray(kernels, np.float64).reshape(len(kernels), -1)
    x = x - x.mean(0, keepdims=True)
    u, _, _ = np.linalg.svd(x.T, full_matrices=False)
    return u[:, :k].astype(np.float32)


def pca_encode(kernels, weight) -> torch.Tensor:
    """[B, l, l] kernels × the [l², k] basis → [B, k] codes."""
    with _fp32_matmul(kernels.device):
        return kernels.reshape(kernels.shape[0], -1) @ weight.to(kernels)


def batch_blur(imgs, kernels) -> torch.Tensor:
    """Each NHWC image blurred by its own [l, l] kernel (``kernels`` [B, l,
    l]), reflect padding (l//2 each side; l//2 − 1 after for an even l):
    one conv of B·C groups."""
    b, h, w, c = imgs.shape
    l = kernels.shape[-1]
    lo, hi = l // 2, (l // 2 if l % 2 else l // 2 - 1)
    x = imgs.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = F.pad(x, (lo, hi, lo, hi), mode="reflect")
    weight = kernels.to(imgs)[:, None].expand(b, c, l, l).reshape(b * c, 1,
                                                                  l, l)
    y = F.conv2d(x, weight, groups=b * c)
    return y.reshape(b, c, h, w).permute(0, 2, 3, 1)


def bicubic_downsample(imgs, scale: int) -> torch.Tensor:
    """NHWC batch → the antialiased MATLAB bicubic at 1/``scale`` (two fp32
    matmuls)."""
    h, w = imgs.shape[1], imgs.shape[2]
    m_h = device_constant(resize_matrix, (h, h // scale, 1.0 / scale, True),
                          F32, imgs.device)
    m_w = device_constant(resize_matrix, (w, w // scale, 1.0 / scale, True),
                          F32, imgs.device)
    with _fp32_matmul(imgs.device):
        out = torch.einsum("oh,bhwc->bowc", m_h, imgs)
        return torch.einsum("pw,bowc->bopc", m_w, out)


def noise_level_draws(batch: int, generator=None, device=None) -> dict:
    """The draws of :func:`random_batch_noise`, each [batch, 1] U[0, 1):
    ``level`` and ``mask`` (at or above ``rate_cln`` keeps the noise)."""
    return {"level": _uniform((batch, 1), 0.0, 1.0, generator, device),
            "mask": _uniform((batch, 1), 0.0, 1.0, generator, device)}


def random_batch_noise(batch: int, high: float, rate_cln: float = 1.0,
                       generator=None, device=None, draws=None):
    """[batch, 1] noise levels: U[0, high), or 0 with probability
    ``rate_cln``."""
    d = draws or noise_level_draws(batch, generator, device)
    return d["level"] * high * (d["mask"] >= rate_cln).to(F32)


def gaussian_noising(imgs, sigma, lo: float = 0.0, hi: float = 1.0,
                     generator=None, noise=None) -> torch.Tensor:
    """``imgs`` + N(0, 1)·σ (``sigma`` [B, 1]), clipped to [lo, hi];
    ``noise``: the N(0, 1) draw, else from ``generator``."""
    if noise is None:
        dev = generator.device if generator is not None else imgs.device
        noise = torch.randn(imgs.shape, generator=generator, device=dev,
                            dtype=F32)
    return torch.clamp(imgs + noise.to(imgs) * sigma[:, None, None, :], lo, hi)


class SRMDPreprocessing:
    """Blur → bicubic down → noise: (LR, kernel code[, kernels]). With
    ``noise`` the code gets the noise level × 10 as a last entry."""

    def __init__(self, scale: int, pca: np.ndarray, random: bool = True,
                 para_input: int = 10, kernel: int = 21, noise: bool = True,
                 sig: float = 2.6, sig_min: float = 0.2, sig_max: float = 4.0,
                 rate_iso: float = 1.0, scaling: float = 3.0,
                 rate_cln: float = 0.2, noise_high: float = 0.08):
        self.pca = torch.as_tensor(np.asarray(pca, np.float32))
        self.scale = scale
        self.random = random
        self.l = kernel
        self.noise = noise
        self.sig, self.sig_min, self.sig_max = sig, sig_min, sig_max
        self.rate_iso, self.scaling = rate_iso, scaling
        self.rate_cln, self.noise_high = rate_cln, noise_high

    def draws(self, hr_batch, generator=None) -> dict:
        """Every draw of one call on ``hr_batch``: ``kernel`` (when
        ``random``), ``level`` and ``noise`` (with ``noise``)."""
        b, h, w, c = hr_batch.shape
        dev = generator.device if generator is not None else hr_batch.device
        out = {}
        if self.random:
            out["kernel"] = random_kernel_draws(b, self.sig_min, self.sig_max,
                                                generator, dev)
        if self.noise:
            out["level"] = noise_level_draws(b, generator, dev)
            out["noise"] = torch.randn(
                (b, h // self.scale, w // self.scale, c), generator=generator,
                device=dev, dtype=F32)
        return out

    def __call__(self, hr_batch, return_kernel: bool = False, generator=None,
                 draws=None):
        d = draws if draws is not None else self.draws(hr_batch, generator)
        dev = hr_batch.device
        b = hr_batch.shape[0]
        if self.random:
            kernels = random_batch_kernel(
                b, self.l, self.sig_min, self.sig_max, self.rate_iso,
                self.scaling, draws={k: v.to(dev) for k, v in
                                     d["kernel"].items()})
        else:
            kernels = stable_batch_kernel(b, self.l, self.sig, dev)
        blurred = batch_blur(hr_batch, kernels)
        code = pca_encode(kernels, self.pca.to(dev))
        lr = bicubic_downsample(blurred, self.scale)
        if self.noise:
            level = random_batch_noise(
                b, self.noise_high, self.rate_cln,
                draws={k: v.to(dev) for k, v in d["level"].items()})
            lr = gaussian_noising(lr, level, noise=d["noise"])
            code = torch.cat([code, level * 10], dim=1)
        if return_kernel:
            return lr, code, kernels
        return lr, code


class IsoGaussian:
    """Isotropic blur of σ ~ U[sig_min, sig_max), bicubic down, optional
    noise of σ ``noise_high``: (LR, kernel code)."""

    def __init__(self, scale: int, pca: np.ndarray, para_input: int = 10,
                 kernel: int = 21, noise: bool = False, sig_min: float = 1.8,
                 sig_max: float = 3.2, noise_high: float = 0.0):
        self.pca = torch.as_tensor(np.asarray(pca, np.float32))
        self.scale = scale
        self.l = kernel
        self.noise = noise
        self.sig_min, self.sig_max = sig_min, sig_max
        self.noise_high = noise_high

    def draws(self, hr_batch, generator=None) -> dict:
        """``sig`` [B] and the N(0, 1) ``noise`` of the LR batch."""
        b, h, w, c = hr_batch.shape
        dev = generator.device if generator is not None else hr_batch.device
        return {"sig": _uniform(b, self.sig_min, self.sig_max, generator, dev),
                "noise": torch.randn((b, h // self.scale, w // self.scale, c),
                                     generator=generator, device=dev,
                                     dtype=F32)}

    def __call__(self, hr_batch, generator=None, draws=None):
        d = draws if draws is not None else self.draws(hr_batch, generator)
        dev = hr_batch.device
        kernels = isotropic_gaussian_kernel(self.l, d["sig"].to(dev))
        blurred = batch_blur(hr_batch, kernels)
        code = pca_encode(kernels, self.pca.to(dev))
        lr = bicubic_downsample(blurred, self.scale)
        if self.noise:
            lr = torch.clamp(lr + d["noise"].to(dev) * self.noise_high, 0.0, 1.0)
        return lr, code
