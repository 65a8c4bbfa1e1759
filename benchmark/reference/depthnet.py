"""Plain PyTorch DepthNet: the benchmark's yardstick for serving and training.

The paper's depth-conditioned SR network written out as its equations, in
NCHW, with nothing folded, packed or fused and no kernel of the program:

  encoder (5 weight-normalized convs; the 4th transposed) → region-wise
  average pooling of the latent under each depth bin's mask (bilinear,
  align_corners, re-binarized at 0.5) → the [B,K,L] style matrix;
  head (2 WN convs) → ``nb - 3`` trunk blocks → global skip → the scale's
  tail (real pixel shuffles) → 9×9 output conv → clamp.

A depth block is conv → InstanceNorm → SEAN → ReLU → conv → InstanceNorm →
SEAN → +x → ReLU, where SEAN normalizes again (parameter-free) and
modulates with γ = α_γ·γ_s + (1 − α_γ)·γ_o (β alike):

  γ_o, β_o = convs over relu(conv(depth map));
  γ_s, β_s = 3×3 convs over the style map Σ_k mask_k · A(style)[k], written
  as its exact factored form Σ_tap Σ_k mask_k(p + tap) · (A(style)[k] · W_tap)
  (a zero-padded conv of a piecewise-constant map), which is also how the
  model's FLOPs are counted.

A classic block is WN conv → ReLU → WN conv → +x → ReLU.

Parameters are a flat ``{name: tensor}`` dict under the reference
checkpoint's names (``param_spec``). ``Numerics`` rounds every conv's and
product's operands: ``fp32`` (none), ``bf16``, or ``fp8`` (float8 e4m3
with a scale per tensor, products summed in fp32), the precision below
bf16 that the ×8 serving control runs in; with ``maps`` it also rounds each
SEAN's finished modulation maps (γ, β) to that dtype, the one rounding that
a configuration with bf16 maps in an fp32 net (``bf16c3``) states.

Imports only ``torch`` and ``numpy``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["Numerics", "param_spec", "forward", "scale_blocks"]

_E4M3_MAX = 448.0


class Numerics:
    """Rounding of the operands of every conv and product: ``"fp32"`` keeps
    them; ``"bf16"`` rounds each to bfloat16; ``"fp8"`` rounds each to
    float8 e4m3 after scaling the tensor's largest magnitude to 448, and
    scales back. ``maps`` (a dtype or None) rounds every SEAN's (γ, β)."""

    def __init__(self, kind: str = "fp32", maps=None):
        if kind not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"numerics must be fp32, bf16 or fp8, got {kind!r}")
        self.kind, self.maps = kind, maps

    def map(self, t):
        """A finished modulation map as ``maps`` stores it."""
        return t if self.maps is None else t.to(self.maps).float()

    def __call__(self, t):
        t = t.float()
        if self.kind == "fp32":
            return t
        if self.kind == "bf16":
            return t.to(torch.bfloat16).float()
        amax = t.detach().abs().amax().clamp_min(1e-30)
        s = _E4M3_MAX / amax
        return (t * s).to(torch.float8_e4m3fn).float() / s


def scale_blocks(scale: int, nb: int):
    """(block index, channels) of every residual block, in order: the trunk's
    ``nb - 3`` blocks, then blocks ``nb - 2`` and ``nb - 1`` (there is no
    block ``nb - 3``). At ×8 the last two run at 32 channels, at ×4 the
    last one."""
    last = 1 if scale == 3 else int(math.log2(scale))
    return [(i, 32 if i > nb - last else 64)
            for i in [*range(nb - 3), nb - 2, nb - 1]]


def param_spec(cfg: dict):
    """[(name, shape, kind, fan_in)] of every parameter of the configured
    network. ``kind``: ``"u"`` U(±1/√fan_in) (torch's conv default),
    ``"g"`` the weight-norm gain ‖v‖ of the ``weight_v`` before it,
    ``"a"`` a blend factor α ~ U[0, 1)."""
    scale, nb = cfg["scale"], cfg["nb"]
    lat, k = cfg["depth_latent_ch"], cfg["depth_masks"]
    which = set(cfg["which_ResBlk_depth"])
    spec = []

    def conv(name, cout, cin, ksz, bias=True):
        fan = cin * ksz * ksz
        spec.append((f"{name}.weight", (cout, cin, ksz, ksz), "u", fan))
        if bias:
            spec.append((f"{name}.bias", (cout,), "u", fan))

    def wn(name, cout, cin, ksz=3, transposed=False):
        # a transposed conv's weight is (in, out, k, k), normed per input
        shape = (cin, cout, ksz, ksz) if transposed else (cout, cin, ksz, ksz)
        fan = shape[1] * ksz * ksz
        spec.append((f"{name}.weight_v", shape, "u", fan))
        spec.append((f"{name}.weight_g", (shape[0], 1, 1, 1), "g", fan))
        spec.append((f"{name}.bias", (cout,), "u", fan))

    wn("encoder.layer1", 32, 3)
    wn("encoder.layer2", 64, 32)
    wn("encoder.layer3", 128, 64)
    wn("encoder.layer4", lat, 128, transposed=True)
    wn("encoder.layer5", lat, lat)
    wn("head.0", 64, 32)
    wn("head.2", 64, 64)
    for i, ch in scale_blocks(scale, nb):
        if i in which:
            p = f"depth-residual{i + 1}"
            conv(f"{p}.conv1.0", ch, ch, 3)
            for n in ("norm1", "norm2"):
                q = f"{p}.{n}"
                spec.append((f"{q}.alpha_gamma", (1,), "a", 0))
                spec.append((f"{q}.alpha_beta", (1,), "a", 0))
                conv(f"{q}.mlp_mask.0", 2 * ch, 1, 3)
                conv(f"{q}.mlp_gamma_o", ch, 2 * ch, 3)
                conv(f"{q}.mlp_beta_o", ch, 2 * ch, 3)
                conv(f"{q}.A_i_j", k, k, 1)
                conv(f"{q}.mlp_gamma_s", ch, lat, 3)
                conv(f"{q}.mlp_beta_s", ch, lat, 3)
                if n == "norm1":
                    conv(f"{p}.conv2.0", ch, ch, 3)
        else:
            p = f"classic-residual{i + 1}"
            wn(f"{p}.block.0", ch, ch)
            wn(f"{p}.block.2", ch, ch)
    fs = 3 if scale == 3 else 2
    if scale == 8:
        wn("upscale1.0", 256, 64)
        wn("upscale1.3", 32, 64)
    if scale >= 4:
        wn("upscale2.0", 128, 32 if scale == 8 else 64)
        wn("upscale2.3", 32, 32)
    wn("upscale3.0", 32 * fs * fs, 32 if scale >= 4 else 64)
    conv("conv_output", 3, 32, 9)
    return spec


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _in(x, eps=1e-5):
    """Parameter-free InstanceNorm (biased variance)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class _Net:
    def __init__(self, p, cfg, num):
        self.p, self.cfg, self.q = p, cfg, num

    def w(self, name):
        return self.p[f"{name}.weight"], self.p[f"{name}.bias"]

    def wn(self, name):
        v, g = self.p[f"{name}.weight_v"], self.p[f"{name}.weight_g"]
        norm = v.square().sum(dim=(1, 2, 3), keepdim=True).sqrt()
        return v * (g / norm), self.p[f"{name}.bias"]

    def conv(self, x, wb, stride=1, pad=None):
        w, b = wb
        pad = w.shape[-1] // 2 if pad is None else pad
        return (F.conv2d(self.q(x), self.q(w), stride=stride, padding=pad)
                + b[:, None, None])

    def encoder(self, x, mask):
        q = self.q
        feat = self.conv(x, self.wn("encoder.layer1"))
        o = self.conv(_lrelu(feat), self.wn("encoder.layer2"), 2)
        o = self.conv(_lrelu(o), self.wn("encoder.layer3"), 2)
        w4, b4 = self.wn("encoder.layer4")
        o = (F.conv_transpose2d(q(_lrelu(o)), q(w4), stride=2, padding=1)
             + b4[:, None, None])
        o = self.conv(_lrelu(o), self.wn("encoder.layer5"), 2)
        m = F.interpolate(mask, size=o.shape[2:], mode="bilinear",
                          align_corners=True)
        m = (m >= 0.5).float()
        num = torch.einsum("bkhw,blhw->bkl", q(m), q(o))
        style = num / (m.sum(dim=(2, 3))[..., None] + 1e-10)
        return _lrelu(feat), style

    def sean(self, x, name, dmap, mask, style):
        """x is already normalized; returns x·(1 + γ) + β."""
        q = self.q
        size = x.shape[2:]
        d = F.interpolate(dmap, size=size, mode="nearest")
        m = F.interpolate(mask, size=size, mode="nearest")
        actv = torch.relu(self.conv(d, self.w(f"{name}.mlp_mask.0")))
        g_o = self.conv(actv, self.w(f"{name}.mlp_gamma_o"))
        b_o = self.conv(actv, self.w(f"{name}.mlp_beta_o"))
        a_w, a_b = self.w(f"{name}.A_i_j")
        mixed = (torch.einsum("kj,bjl->bkl", q(a_w[:, :, 0, 0]), q(style))
                 + a_b[:, None])
        out = []
        for br in ("gamma", "beta"):
            ws, bs = self.w(f"{name}.mlp_{br}_s")
            # per tap and bin kernels [B, K, C, 3, 3], then one conv per image
            # of the K mask channels
            v = torch.einsum("bkl,clyx->bkcyx", q(mixed), q(ws))
            y = torch.cat([
                F.conv2d(q(m[i:i + 1]), q(v[i]).transpose(0, 1), padding=1)
                for i in range(m.shape[0])]) + bs[:, None, None]
            out.append(y)
        ag = self.p[f"{name}.alpha_gamma"]
        ab = self.p[f"{name}.alpha_beta"]
        gamma = q.map(ag * out[0] + (1 - ag) * g_o)
        beta = q.map(ab * out[1] + (1 - ab) * b_o)
        return x * (1 + gamma) + beta

    def block(self, i, x, depth):
        if i not in set(self.cfg["which_ResBlk_depth"]):
            p = f"classic-residual{i + 1}"
            h = torch.relu(self.conv(x, self.wn(f"{p}.block.0")))
            return torch.relu(x + self.conv(h, self.wn(f"{p}.block.2")))
        p = f"depth-residual{i + 1}"
        h = _in(_in(self.conv(x, self.w(f"{p}.conv1.0"))))
        h = torch.relu(self.sean(h, f"{p}.norm1", *depth))
        h = _in(_in(self.conv(h, self.w(f"{p}.conv2.0"))))
        h = self.sean(h, f"{p}.norm2", *depth)
        return torch.relu(x + h)

    def forward(self, x, dmap, mask):
        scale, nb = self.cfg["scale"], self.cfg["nb"]
        feat, style = self.encoder(x, mask)
        depth = (dmap, mask, style)
        fea = _lrelu(self.conv(feat, self.wn("head.0")))
        fea_bef = _lrelu(self.conv(fea, self.wn("head.2")))
        z = fea_bef
        for i in range(nb - 3):
            z = self.block(i, z, depth)
        z = z + fea_bef
        if scale == 8:
            h = F.pixel_shuffle(_lrelu(self.conv(z, self.wn("upscale1.0"))), 2)
            z = _lrelu(self.conv(h, self.wn("upscale1.3")))
        z = self.block(nb - 2, z, depth)
        if scale >= 4:
            z = F.pixel_shuffle(_lrelu(self.conv(z, self.wn("upscale2.0"))), 2)
            z = _lrelu(self.conv(z, self.wn("upscale2.3")))
        z = self.block(nb - 1, z, depth)
        fs = 3 if scale == 3 else 2
        h = F.pixel_shuffle(self.conv(z, self.wn("upscale3.0")), fs)
        out = self.conv(_lrelu(h), self.w("conv_output"), pad=4)
        return out


def forward(params, cfg, lq, depth, masks, numerics=None, clamp=(0.0, 1.0)):
    """SR of NHWC ``lq`` [B,H,W,3], ``depth`` [B,H,W,1] and ``masks``
    [B,H,W,K] → NHWC [B,sH,sW,3] fp32, clamped to ``clamp`` (None: not
    clamped). Differentiable in ``params``."""
    num = numerics or Numerics("fp32")
    nchw = [t.float().permute(0, 3, 1, 2) for t in (lq, depth, masks)]
    out = _Net(params, cfg, num).forward(*nchw)
    if clamp is not None:
        out = out.clamp(*clamp)
    return out.permute(0, 2, 3, 1)
