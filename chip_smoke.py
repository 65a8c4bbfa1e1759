#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``endosr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device — the card's name and power limit; TF32 off for fp32 checks.
2. build — every kernel under ``endosr_torch/csrc`` with one ``nvcc`` per
   source, all started together, into ``build/endosr_torch/``.
3. kernels — each of the eight kernels against its plain PyTorch version
   at the shapes the full-width forwards give it, in bf16 (max|Δ|/max|ref|
   ≤ 1e-2) and fp32 (≤ 1e-5 against float64); ``in_stats`` ≤ 1e-5 against
   float64 sums in both; ``output_stage_x8`` (the ×8 HBWC and the ×4 BHWC
   shape) and ``output_stage`` (r = 2, 3, 4) must be bit-identical. Times
   are CUDA-event medians of 20 runs, beside the plain version's, the bound
   (larger of bytes over 3.35 TB/s and operations over the bf16 tensor-core
   peak), and one PyTorch call computing the same function where there is
   one.
4. small forwards — reduced DepthNets through the kernels in fp32 against
   the same weights on the CPU (plain versions), ≤ 2e-4 max abs: ×8, ×2,
   ×3, ×4, ×4 with the fused epilogue, and ×8 with ``valid_hw`` on a
   zero-padded odd-sized input.
5. serving, three full-width paths through ``FModelDepthCond`` (seeded
   weights, batch 8, bf16), the launch counts set to 0 before each and read
   after it; every output finite, of the right shape, in [0,1]; bf16 vs
   fp32 PSNR ≥ 40 dB on the same weights:
   - ×8 flagship, unbucketed, LQ 128² → SR 1024²: ``packed_g123`` 2,
     ``style_blend_dot`` 2, ``head_dot`` 1, ``output_stage_x8`` 1 per
     forward;
   - ×8 flagship with ``eval_bucket_multiple`` unset (bucket 32), LQ
     120×112 → SR 960×896 through the masked forward: ``style_dot_hwbm`` 2,
     ``output_stage`` 1, none of the packed kernels; the fp32 output equals
     the fp32 unbucketed output of the same request to ≤ 1e-4;
   - ×4 flagship with ``fused_epilogue`` and ``in_stats: kernel``, LQ 128²
     → SR 512²: ``fused_in_mod`` 26, ``in_stats`` 26, ``style_blend_dot``
     2, ``output_stage_x8`` 1; the fp32 output equals that of the chained
     epilogue (``fused_epilogue: false``) to ≤ 2e-4.

Prints the kernels JSON line (``launches`` summed over the three paths),
then the ``nvidia-smi`` name/power line, then ``{"ok": true, "device":
{...}}`` as the last line. Exits non-zero without a result when no CUDA
device is present or when run outside the repository.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

HBM_BPS = 3.35e12       # H100 SXM device memory rate
BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
N_TIMED = 20


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, n=N_TIMED):
    """Median CUDA-event time of ``fn()`` over ``n`` runs, after warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(bytes_, flops):
    tb, tf = bytes_ / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rel_err(got, ref):
    """(max |Δ|, max |Δ| / max |ref|) of a tensor or a tuple of tensors
    (the worst of its members)."""
    if isinstance(got, tuple):
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        return max(e[0] for e in errs), max(e[1] for e in errs)
    got, ref = got.double(), ref.double()
    return (float((got - ref).abs().max()),
            float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)))


class KernelCase:
    """One kernel at one shape: its call, plain call, library call and the
    bytes/operations of the work. ``main``: its times enter the JSON row
    (the shapes of the first full-width path that runs the kernel); other
    shapes are checked and logged only. ``exact``: must equal the plain
    version bit for bit. ``ref64``: the float64 reference where the plain
    version cannot be fed float64. ``tol``: overrides the per-dtype
    tolerance."""

    def __init__(self, name, kernel, plain, library, bytes_, flops, main=True,
                 exact=False, ref64=None, tol=None):
        self.name, self.kernel, self.plain = name, kernel, plain
        self.library, self.bytes, self.flops = library, bytes_, flops
        self.main, self.exact, self.ref64, self.tol = main, exact, ref64, tol


def make_cases(torch, dt, gen):
    """The eight kernels at the shapes the full-width forwards give them
    (B=8, LR 128; packed_g123, style_blend_dot and style_dot_hwbm twice)."""
    import torch.nn.functional as F

    from endosr_torch.kernels.fused_in_mod import (fused_in_mod,
                                                   fused_in_mod_plain)
    from endosr_torch.kernels.head_dot import head_dot, head_dot_plain
    from endosr_torch.kernels.in_stats import in_stats, in_stats_plain
    from endosr_torch.kernels.output_stage import (output_stage,
                                                   output_stage_plain,
                                                   output_stage_x8,
                                                   output_stage_x8_plain)
    from endosr_torch.kernels.packed_chain import packed_g123, packed_g123_plain
    from endosr_torch.kernels.style_dot import (style_blend_dot,
                                                style_blend_plain,
                                                style_dot_hwbm, style_dot_plain)

    dev = "cuda"

    def rn(*shape, s=1.0, mean=0.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev) * s
                + mean).to(dtype)

    B = 8
    cases = {}

    # output_stage_x8: the ×8 forward's pre64 [256, 8, 256, 64] HBWC (the
    # JSON row) and the ×4 unmasked forward's [8, 128, 128, 64] BHWC
    xcs = []
    for label, shape, order, main in (("x8 hbwc", (256, B, 256, 64), "hbwc", True),
                                      ("x4 bhwc", (B, 128, 128, 64), "bhwc", False)):
        pre64 = rn(*shape, s=0.6, mean=0.5)
        xcs.append(KernelCase(
            f"output_stage_x8[{label}]",
            lambda p=pre64, o=order: output_stage_x8(p, 0.0, 1.0, o),
            lambda p=pre64, o=order: output_stage_x8_plain(p, 0.0, 1.0, o),
            None, nbytes(pre64) + pre64.numel() // 64 * 48 * 4, 0, main=main,
            exact=True))
    cases["output_stage_x8"] = xcs

    # output_stage: the bucketed ×8 forward's [8,256,256,48] r=4 (main path),
    # and the ×4 / ×2 / ×3 tails' shapes
    ocs = []
    for label, hw, r, main in (("x8 r=4", 256, 4, True), ("x4 r=4", 128, 4, False),
                               ("x2 r=2", 128, 2, False), ("x3 r=3", 128, 3, False)):
        pre = rn(B, hw, hw, 3 * r * r, s=0.6, mean=0.5)
        ocs.append(KernelCase(
            f"output_stage[{label}]",
            lambda p=pre, r=r: output_stage(p, r, 0.0, 1.0),
            lambda p=pre, r=r: output_stage_plain(p, r, 0.0, 1.0),
            None, nbytes(pre) + B * hw * hw * 3 * r * r * 4, 0, main=main,
            exact=True))
    cases["output_stage"] = ocs

    # in_stats and fused_in_mod: one trunk activation [8,128,128,64]; γ and β
    # are channel slices of a group's [8,128,128,M] map, as on the main path
    xs = rn(B, 128, 128, 64, s=1.5, mean=0.5)
    cases["in_stats"] = [KernelCase(
        "in_stats", lambda x=xs: in_stats(x), lambda x=xs: in_stats_plain(x),
        lambda x=xs: torch.var_mean(x.float(), dim=(1, 2)),
        nbytes(xs) + 2 * B * 64 * 4, 3 * xs.numel(),
        ref64=lambda x=xs: (x.double().sum(dim=(1, 2)),
                            x.double().square().sum(dim=(1, 2))),
        tol=1e-5)]
    gb = rn(B, 128, 128, 256, s=0.3)
    gam, bet = gb[..., 64:128], gb[..., 128:192]

    def in_mod_64(x=xs, g=gam, b=bet):
        x, g, b = x.double(), g.double(), b.double()
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) * (1.0 + g) + b
    cases["fused_in_mod"] = [KernelCase(
        "fused_in_mod", lambda x=xs, g=gam, b=bet: fused_in_mod(x, g, b),
        lambda x=xs, g=gam, b=bet: fused_in_mod_plain(x, g, b), None,
        4 * nbytes(xs), 8 * xs.numel(), ref64=in_mod_64)]

    # head_dot: g4 [257, 257, 8, 512] (HWNC view of the producer's BHWC)
    g4 = rn(B, 257, 257, 512, s=0.5).permute(1, 2, 0, 3)
    w64 = rn(3, 3, 512, 64, s=0.02)
    b64 = rn(64, s=0.1, dtype=torch.float32)
    pb = rn(512, s=0.1)
    # yardstick: one cuDNN conv over the already-activated NCHW input
    g4_act = F.leaky_relu(g4.permute(2, 3, 0, 1) + pb[None, :, None, None], 0.2)
    w64_oihw = w64.permute(3, 2, 0, 1).contiguous()

    def head_lib():
        return F.conv2d(g4_act, w64_oihw, padding=1)
    cases["head_dot"] = [KernelCase(
        "head_dot",
        lambda: head_dot(g4, w64, b64, 256, pb),
        lambda g=g4, w=w64, b=b64, p=pb: head_dot_plain(g, w, b, 256, p),
        head_lib,
        nbytes(g4, w64, b64, pb) + 256 * B * 256 * 64 * g4.element_size(),
        2 * B * 256 * 256 * 9 * 512 * 64)]

    # packed_g123: up1 chain (x [128,128,8,256], pre_act) and tail chain
    # (packed producer [129,129,8,512], phases + pre_act + pre_bias)
    pcs = []
    for label, xshape, cin4, phases in (("up1", (B, 128, 128, 256), 256, False),
                                        ("tail", (B, 129, 129, 512), 128, True)):
        x = rn(*xshape, s=0.5).permute(1, 2, 0, 3)
        k1 = rn(2, 2, cin4, 128, s=1.0 / math.sqrt(4 * cin4))
        k2 = rn(2, 2, 128, 128, s=1.0 / math.sqrt(512))
        k3 = rn(2, 2, 128, 128, s=1.0 / math.sqrt(512))
        b1, b2, b3 = (rn(128, s=0.1) for _ in range(3))
        pbias = rn(cin4, s=0.1) if phases else None
        n = (2 * 128 if phases else 128) + 1
        args = (x, k1, b1, k2, b2, k3, b3)
        kw = dict(pre_act=True, pre_bias=pbias, phases=phases)
        flops = 2 * B * n * n * 4 * (cin4 * 128 + 2 * 128 * 128)
        pcs.append(KernelCase(
            f"packed_g123[{label}]",
            lambda a=args, k=kw: packed_g123(*a, **k),
            lambda a=args, k=kw: packed_g123_plain(*a, **k),
            None,
            nbytes(x, k1, k2, k3, b1, b2, b3,
                   *([pbias] if pbias is not None else []))
            + n * n * B * 128 * x.element_size(),
            flops))
    cases["packed_g123"] = pcs

    # style_blend_dot: the 7- and 6-block groups (M = 1792 / 1536)
    scs = []
    masks = (torch.rand((B, 128, 128, 90), generator=gen, device=dev)
             > 0.8).to(dt)
    for nblk in (7, 6):
        m = nblk * 2 * 128
        v = rn(B, 90, m, s=0.05)
        convs = tuple(rn(B, 128, 128, 128, s=0.3).permute(1, 2, 0, 3)
                      for _ in range(2 * nblk))
        bias = rn(m, s=0.1, dtype=torch.float32)
        cat = torch.cat([c.permute(2, 0, 1, 3) for c in convs], dim=-1)
        cat = cat.reshape(B, 128 * 128, m)
        sflat = masks.reshape(B, 128 * 128, 90)
        bias_dt = bias.to(dt)
        scs.append(KernelCase(
            f"style_blend_dot[M={m}]",
            lambda s=masks, vv=v, c=convs, b=bias: style_blend_dot(s, vv, c, b),
            lambda s=masks, vv=v, c=convs, b=bias: style_blend_plain(s, vv, c, b),
            lambda c=cat, s=sflat, vv=v, b=bias_dt:
                torch.baddbmm(c, s, vv).add_(b),
            nbytes(masks, v, bias, *convs) + 128 * 128 * B * m * masks.element_size(),
            2 * B * 128 * 128 * 90 * m))
    cases["style_blend_dot"] = scs

    # style_dot_hwbm: the same two groups on the masked path
    hcs = []
    for nblk in (7, 6):
        m = nblk * 2 * 128
        v = rn(B, 90, m, s=0.05)
        sflat = masks.reshape(B, 128 * 128, 90)
        hcs.append(KernelCase(
            f"style_dot_hwbm[M={m}]",
            lambda s=masks, vv=v: style_dot_hwbm(s, vv),
            lambda s=masks, vv=v: style_dot_plain(s, vv),
            lambda s=sflat, vv=v: torch.bmm(s, vv),
            nbytes(masks, v) + 128 * 128 * B * m * masks.element_size(),
            2 * B * 128 * 128 * 90 * m))
    cases["style_dot_hwbm"] = hcs
    return cases


SOURCES = {
    "packed_g123": ("endosr_torch/csrc/packed_chain.cu",
                    "endosr/kernels/packed_chain.py:438"),
    "style_blend_dot": ("endosr_torch/csrc/style_dot.cu",
                        "endosr/kernels/style_dot.py:284"),
    "head_dot": ("endosr_torch/csrc/head_dot.cu",
                 "endosr/kernels/head_dot.py:283"),
    "output_stage_x8": ("endosr_torch/csrc/output_stage.cu",
                        "endosr/kernels/output_stage.py:275"),
    "output_stage": ("endosr_torch/csrc/output_stage.cu",
                     "endosr/kernels/output_stage.py:316"),
    "style_dot_hwbm": ("endosr_torch/csrc/style_dot.cu",
                       "endosr/kernels/style_dot.py:111"),
    "fused_in_mod": ("endosr_torch/csrc/fused_in_mod.cu",
                     "endosr/kernels/fused_in_mod.py:95"),
    "in_stats": ("endosr_torch/csrc/in_stats.cu",
                 "endosr/kernels/in_stats.py:47"),
}


def check_kernels(torch):
    """Phase 3: kernels against plain versions; returns the JSON rows
    (without launches)."""
    rows = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        cases = make_cases(torch, dt, gen)
        for name, cs in cases.items():
            worst_abs = 0.0
            tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": 0.0 if cs[0].library else None}
            for c in cs:
                got = c.kernel()
                torch.cuda.synchronize()
                ctol = c.tol or tol
                if c.exact:
                    ref = c.plain()
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{c.name} {dt}: not bit-identical "
                                             f"(max |Δ| {rel_err(got, ref)[0]})")
                    err_abs, err_rel = 0.0, 0.0
                elif dt == torch.float32 or c.tol:
                    # float64 on the same values: the plain version, or the
                    # case's own reference
                    ref = c.ref64() if c.ref64 else _plain_f64(torch, c)
                    err_abs, err_rel = rel_err(got, ref)
                else:
                    ref = c.plain()
                    err_abs, err_rel = rel_err(got, ref)
                log(f"{c.name} {str(dt)[6:]}: max|Δ| {err_abs:.3e} "
                    f"rel {err_rel:.3e} (tol {ctol:g})")
                if not err_rel <= ctol:
                    raise AssertionError(f"{c.name} {dt}: rel err {err_rel} > {ctol}")
                worst_abs = max(worst_abs, err_abs)
                del got, ref
                if dt == torch.bfloat16:
                    ms = cuda_ms(c.kernel)
                    pms = cuda_ms(c.plain)
                    lms = cuda_ms(c.library) if c.library else None
                    bms, by = bound_ms(c.bytes, c.flops)
                    log(f"  {c.name} bf16: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                        f"library {'-' if lms is None else f'{lms:.4f} ms'}, "
                        f"bound {bms:.4f} ms ({by}; {c.bytes / 1e6:.1f} MB, "
                        f"{c.flops / 1e9:.1f} GFLOP)")
                    if not c.main:
                        continue
                    tot["ms"] += ms
                    tot["plain_ms"] += pms
                    tot["bound_ms"] += bms
                    if lms is not None:
                        tot["library_ms"] += lms
                    tot["bound_by"] = by
            rows.setdefault(name, {"max_abs_err": {}})
            rows[name]["max_abs_err"][str(dt)[6:]] = worst_abs
            if dt == torch.bfloat16:
                rows[name].update(tot)
        del cases
        torch.cuda.empty_cache()
    return rows


def _plain_f64(torch, case):
    """Evaluate a case's plain version on float64 copies of its inputs."""
    fn = case.plain
    defaults = fn.__defaults__ or ()

    def up(a):
        if torch.is_tensor(a) and a.is_floating_point():
            return a.double()
        if isinstance(a, tuple):
            return tuple(up(x) for x in a)
        if isinstance(a, dict):
            return {k: up(v) for k, v in a.items()}
        return a

    return fn(*(up(d) for d in defaults))


def flagship_opt(precision, scale=8, bucket=0, **net):
    """The flagship DepthNet serving options; ``bucket=None`` leaves
    ``eval_bucket_multiple`` unset (the default, 32); ``net`` adds
    ``network_G`` keys."""
    opt = {
        "is_train": False, "model": "sftmd_depthCond", "scale": scale,
        "precision": precision,
        "datasets": {"test": {"depthMaskNum": 10}},
        "network_G": {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3,
                      "nf": 64, "nb": 16, "depth_latent_ch": 256,
                      "which_ResBlk_depth": list(range(14)),
                      "use_trainable_params": True, **net},
        "path": {}, "train": {"manual_seed": 0},
    }
    if bucket is not None:
        opt["eval_bucket_multiple"] = bucket
    return opt


def small_forwards(torch):
    """Phase 4: reduced DepthNets through the kernels (fp32) vs the same
    weights through the plain versions on the CPU."""
    import torch.nn.functional as F

    from endosr_torch.nn.depthnet import DepthNet
    from endosr_torch.ops.masks import pool_mask_np
    from endosr_torch.utils.port_params import seeded_init

    base = dict(nb=6, depth_latent_ch=16, depth_range_num=4, style_chunk=2)
    every = (0, 1, 2, 3, 4, 5)
    cases = [
        ("x8", dict(scale=8, which_resblk_depth=(0, 1, 2)), None),
        ("x2", dict(scale=2, which_resblk_depth=every), None),
        ("x3", dict(scale=3, which_resblk_depth=every), None),
        ("x4", dict(scale=4, which_resblk_depth=(0, 1, 2)), None),
        ("x4 fused_epilogue", dict(scale=4, which_resblk_depth=(0, 1, 2),
                                   fused_epilogue=True, in_stats="kernel"), None),
        ("x8 valid_hw", dict(scale=8, which_resblk_depth=(0, 1, 2)), (29, 26)),
    ]
    g = torch.Generator().manual_seed(1)
    for label, kw, valid in cases:
        cpu = seeded_init(DepthNet(**base, **kw, device="cpu"), 0)
        gpu = DepthNet(**base, **kw, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        h, w = valid or (32, 32)
        x = torch.rand((2, h, w, 3), generator=g)
        d = torch.rand((2, h, w, 1), generator=g)
        m = (torch.rand((2, h, w, 4), generator=g) > 0.6).float()
        extra = {}
        if valid:
            pm = pool_mask_np(m.numpy(), (((h + 1) // 2 + 1) // 2,
                                          ((w + 1) // 2 + 1) // 2), (8, 8))
            pad = (0, 0, 0, 32 - w, 0, 32 - h)
            x, d, m = (F.pad(t, pad) for t in (x, d, m))
            extra = dict(valid_hw=valid, pool_mask=torch.from_numpy(pm))
        want = cpu(x, d, m, **extra)
        got = gpu(x.cuda(), d.cuda(), m.cuda(),
                  **{k: v.cuda() if torch.is_tensor(v) else v
                     for k, v in extra.items()}).cpu()
        s = kw["scale"]
        err = float((got - want)[:, :h * s, :w * s].abs().max())
        log(f"small DepthNet {label} fp32, kernels on the card vs plain on "
            f"the CPU: max|Δ| {err:.3e} (tol 2e-4)")
        if not err <= 2e-4:
            raise AssertionError(f"small forward {label} differs: {err}")


def psnr(a, b):
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")


def serve(torch, counters, label, opt16, opt32, lr_hw, want, on_host,
          n_requests=2, also32=None):
    """Phase 5, one full-width path: ``n_requests`` batch-8 requests of LQ
    ``lr_hw`` through ``FModelDepthCond(opt16)`` (bf16) with the launch
    counts of ``counters`` set to 0 just before and read just after; then
    the first request through ``opt32`` (fp32, same weights) for the PSNR,
    and through ``also32`` = (label, options, tolerance), whose fp32 output
    must equal ``opt32``'s. ``on_host``: requests are numpy arrays, as a
    data loader hands them over. Returns (per-request seconds, launches)."""
    import numpy as np

    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.ops.masks import depth_masks, depth_masks_np

    h, w = lr_hw
    s = opt16["scale"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)

    def request():
        if on_host:
            dep = rng.random((8, h, w, 1), dtype=np.float32)
            return {"LQ": rng.random((8, h, w, 3), dtype=np.float32),
                    "Depth": dep,
                    "DepthMaskList": np.stack(
                        [depth_masks_np(d, True, 10) for d in dep])}
        lq = torch.rand((8, h, w, 3), generator=gen, device="cuda")
        dep = torch.rand((8, h, w, 1), generator=gen, device="cuda")
        return {"LQ": lq, "Depth": dep,
                "DepthMaskList": depth_masks(dep[..., 0], True, 10)}

    t0 = time.perf_counter()
    model = FModelDepthCond(opt16)
    log(f"[{label}] FModelDepthCond bf16 built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.netG.parameters()):,} parameters)")
    reqs = [request() for _ in range(n_requests)]
    model.feed_data(reqs[0])
    model.test()                                   # warm-up request
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    lat, outs = [], []
    for r in reqs:
        t = time.perf_counter()
        model.feed_data(r)
        sr = model.test()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        outs.append(sr)
    launches = {c.__name__: c.launches for c in counters}

    shape = (8, h * s, w * s, 3)
    for k, sr in enumerate(outs):
        if tuple(sr.shape) != shape or sr.dtype != torch.float32:
            raise AssertionError(f"[{label}] request {k}: SR "
                                 f"{tuple(sr.shape)} {sr.dtype}")
        if not bool(torch.isfinite(sr).all()):
            raise AssertionError(f"[{label}] request {k}: non-finite SR")
        lo, hi = float(sr.min()), float(sr.max())
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"[{label}] request {k}: SR outside [0,1]: "
                                 f"{lo}, {hi}")
        log(f"[{label}] request {k}: SR {list(shape)} fp32, range "
            f"[{lo:.4f}, {hi:.4f}], mean {float(sr.mean()):.4f}")
    for c in counters:
        per = want.get(c.__name__, 0)
        if launches[c.__name__] != per * n_requests:
            raise AssertionError(
                f"[{label}] {c.__name__}: {launches[c.__name__]} launches in "
                f"{n_requests} forwards, want {per} each")

    sr16 = outs[0].clone()
    del outs
    sd = model.netG.state_dict()
    del model
    torch.cuda.empty_cache()

    def fp32_output(opt):
        m32 = FModelDepthCond(opt)
        m32.netG.load_state_dict(sd)
        m32.feed_data(reqs[0])
        return m32.test().clone()

    sr32 = fp32_output(opt32)
    db = psnr(sr16, sr32)
    log(f"[{label}] bf16 vs fp32 SR PSNR on the same weights: {db:.2f} dB "
        f"(min 40)")
    if not db >= 40.0:
        raise AssertionError(f"[{label}] bf16 vs fp32 PSNR {db} < 40 dB")
    if also32:
        what, opt, tol = also32
        err = float((fp32_output(opt) - sr32).abs().max())
        log(f"[{label}] fp32 output vs {what}: max|Δ| {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"[{label}] differs from {what}: {err}")
    torch.cuda.empty_cache()
    med = sorted(lat)[len(lat) // 2]
    log(f"[{label}] batch 8, LQ {h}×{w} → SR {h * s}×{w * s}, bf16; "
        f"per-request latency " + ", ".join(f"{x * 1e3:.2f}" for x in lat)
        + f" ms; median {med * 1e3:.2f} ms = {8 / med:.2f} frames/s")
    return lat, launches


def serving_paths(torch, counters):
    """The three full-width paths; returns {label: launches}."""
    fused = dict(fused_epilogue=True, in_stats="kernel")
    paths = [
        dict(label="x8 unbucketed", opt16=flagship_opt("bf16"),
             opt32=flagship_opt("fp32"), lr_hw=(128, 128), on_host=False,
             n_requests=3,
             want={"packed_g123": 2, "style_blend_dot": 2, "head_dot": 1,
                   "output_stage_x8": 1}),
        dict(label="x8 bucketed", opt16=flagship_opt("bf16", bucket=None),
             opt32=flagship_opt("fp32", bucket=None), lr_hw=(120, 112),
             on_host=True, want={"style_dot_hwbm": 2, "output_stage": 1},
             also32=("the unbucketed forward", flagship_opt("fp32"), 1e-4)),
        dict(label="x4 fused_epilogue",
             opt16=flagship_opt("bf16", 4, None, **fused),
             opt32=flagship_opt("fp32", 4, None, **fused), lr_hw=(128, 128),
             on_host=False,
             want={"fused_in_mod": 26, "in_stats": 26, "style_blend_dot": 2,
                   "output_stage_x8": 1},
             also32=("the chained epilogue", flagship_opt("fp32", 4, 0), 2e-4)),
    ]
    return {p["label"]: serve(torch, counters, **p)[1] for p in paths}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from endosr_torch.kernels import _build
    from endosr_torch.kernels.fused_in_mod import fused_in_mod
    from endosr_torch.kernels.head_dot import head_dot
    from endosr_torch.kernels.in_stats import in_stats
    from endosr_torch.kernels.output_stage import output_stage, output_stage_x8
    from endosr_torch.kernels.packed_chain import packed_g123
    from endosr_torch.kernels.style_dot import style_blend_dot, style_dot_hwbm

    t_start = time.perf_counter()
    gpu = gpu_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {gpu} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    times = _build.build_all()
    log(f"built kernels (seconds since the builds started): "
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    for src in _build.SOURCES:
        txt = (_build.BUILD / f"{src}.log")
        if txt.exists():
            for line in txt.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {src}: {line.strip()}")

    rows = check_kernels(torch)
    small_forwards(torch)
    counters = [packed_g123, style_blend_dot, head_dot, output_stage_x8,
                output_stage, style_dot_hwbm, fused_in_mod, in_stats]
    by_path = serving_paths(torch, counters)
    log(f"served on {gpu}")

    out = []
    for kname, (src, repl) in SOURCES.items():
        r = rows[kname]
        out.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(p[kname] for p in by_path.values()),
            "launches_by_path": {k: p[kname] for k, p in by_path.items()},
            "max_abs_err": r["max_abs_err"]["bfloat16"],
            "max_abs_err_fp32": r["max_abs_err"]["float32"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
